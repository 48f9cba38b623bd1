// BVH closest-hit and any-hit ray queries for NVIDIA Hopper (sm_90a).
//
// Replace mitsuba_tpu/ops/pallas/traverse.py::packet_closest_hit (:2133)
// and ::packet_any_hit (:2240): for each active ray, the closest face
// within 0 < t <= maxt (t, face id), or whether any face lies within maxt
// (occluded).  The wavefront PathIntegrator queries them once a depth
// each on scenes above 1024 faces: closest hit, then shadow rays.
//
// The TPU kernels walk a packet BVH of their own (128-lane packets, an
// MXU leaf stage, SMEM queues); that tree is a TPU layout and is not
// carried over.  These walk the port's SAH tree, one ray a thread.  Ties
// follow ops/bvh.py's walk (the first face in DFS order among equal t),
// not the packet tree's.
//
// What bounds them on this card: operations (box and triangle tests).
// What holds them far above that bound is waiting: a walk is a chain of
// dependent loads from L2, where the tables (about 7 MB at 82k faces)
// stay, and the lanes of a warp walk different paths of different
// lengths.  Past the first depth many ray slots of a launch are dead
// (escaped, ended by Russian roulette, or shadow rays never cast), and a
// warp of one slot a thread runs with those lanes idle and lives as long
// as its longest walk.
//
// Design:
// - The walk: csrc/bvh_pair_walk.cuh's two-child-box walk (the BVH
//   megakernels' own), whose 64-byte record holds both children's boxes,
//   so a missed child costs no fetch, a leaf child is tested at its
//   parent and the nearer child goes first.  Its stack caps the tree's
//   depth at PAIR_STACK; a deeper tree (the wavefront path is the
//   fallback for every scene) takes csrc/bvh_walk.cuh's stackless
//   miss-link walk in the same grid.  The route is picked from the tree's
//   depth before the launch.  Both give ops/bvh.py's answer: the closest
//   walk clips box tests at min(best, maxt) but accepts a triangle below
//   the best alone, and a hit beyond maxt is dropped afterwards, so every
//   box the plain walk tests is tested and the closest hit within maxt is
//   the closest of all tests when it lies within maxt; the any-hit walk
//   returns at its first occluder.  The pair walk's nearer-first order
//   parts from it only where a triangle's t rounds below its box's tnear
//   (ops/bvh.py pair_walk, its eager twin; tests/test_torch_bvh.py builds
//   the case).
// - Active-ray compaction in a persistent grid (csrc/intersect_packed.cu's,
//   moved from the block to the warp): as many blocks as the card holds
//   at once; each warp takes CHUNK = 32 ray slots at a time from a
//   counter in device memory (claiming the next chunk a chunk ahead),
//   ballots their active flags, writes the inactive slots' misses at once
//   and appends the active slot ids to its own ring queue in shared
//   memory, in slot order.  Whenever the queue holds 32 rays (or the
//   slots have run out) every lane walks one queued ray.  Only __syncwarp
//   orders a warp's queue: no block-wide barrier holds a warp to
//   another's longest walk, which for a BVH walk varies far more than for
//   a brute sweep.
// - A ray's answer depends on the ray and the tree alone, not on the
//   thread that takes it, so no schedule changes a result.
// Measured on an H100 (PERF.md, utils/compare_designs.py --phases hits):
// the pair walk is what gains; the compaction pays only on launches with
// few live rays and costs on dense ones, where each lane's walk is a
// latency-bound chain that a fuller warp does not shorten.

#include "bvh_pair_walk.cuh"
#include "persistent.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;  // ray slots a warp takes from the counter at once
constexpr int QUEUE = 64;  // a warp's ring of queued slot ids

// The walk of ray i, its outputs written to slot i.
template <bool ANY, class Query>
__device__ __forceinline__ void trace_ray(
    const Query& q, int i, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ maxt,
    float* __restrict__ t_out, int32_t* __restrict__ face,
    uint8_t* __restrict__ occluded) {
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float mt = maxt[i];
  float t;
  const int s = q.template walk<ANY>(ox, oy, oz, dx, dy, dz, mt, t);
  if constexpr (ANY) {
    occluded[i] = s >= 0;
  } else {
    const bool hit = s >= 0 && t <= mt;
    t_out[i] = hit ? t : CUDART_INF_F;
    face[i] = hit ? __ldg(q.face + s) : -1;
  }
}

template <bool ANY, class Query>
__global__ void __launch_bounds__(THREADS)
hit_kernel(Query q, const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ maxt, const uint8_t* __restrict__ active,
           int n, float* __restrict__ t_out, int32_t* __restrict__ face,
           uint8_t* __restrict__ occluded, unsigned* __restrict__ next_slot) {
  // the queue holds fewer than 32 rays before a chunk's appends
  static_assert(31 + CHUNK <= QUEUE && (QUEUE & (QUEUE - 1)) == 0,
                "a warp's ring must hold a batch less one plus a chunk");
  __shared__ int queue[WARPS][QUEUE];
  int* ring = queue[threadIdx.x >> 5];
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int head = 0, tail = 0;  // queued: [head, tail), the same in every lane
  // lane 0 claims the next chunk a chunk ahead, so the counter's round
  // trip overlaps this chunk's walks
  unsigned claimed = 0;
  if (lane == 0) claimed = atomicAdd(next_slot, (unsigned)CHUNK);
  for (;;) {
    const unsigned base = __shfl_sync(FULL_MASK, claimed, 0);
    const bool more = base < (unsigned)n;
    if (more) {
      if (lane == 0) claimed = atomicAdd(next_slot, (unsigned)CHUNK);
      const unsigned i = base + lane;
      const bool in = i < (unsigned)n;
      const bool act = in && active[i] != 0;
      const unsigned ballot = __ballot_sync(FULL_MASK, act);
      if (act) {
        ring[(tail + __popc(ballot & below)) & (QUEUE - 1)] = (int)i;
      } else if (in) {
        if constexpr (ANY) {
          occluded[i] = 0;
        } else {
          t_out[i] = CUDART_INF_F;
          face[i] = -1;
        }
      }
      tail += __popc(ballot);
      __syncwarp();  // the appends are visible to the whole warp
    }
    while (tail - head >= 32 || (!more && tail > head)) {
      const int take = tail - head < 32 ? tail - head : 32;
      const int i = (int)lane < take ? ring[(head + lane) & (QUEUE - 1)] : -1;
      head += take;
      __syncwarp();  // every lane has read before the next appends
      if (i >= 0) trace_ray<ANY>(q, i, o, d, maxt, t_out, face, occluded);
    }
    if (!more) return;
  }
}

// Whether a tree `depth` inner nodes deep takes the pair walk.
bool pair_route(int depth) { return depth <= PAIR_STACK; }

// Fills `g` for a launch of the `any` query over n > 0 rays with walk `q`
// and, if `run`, launches it.
template <class Query>
cudaError_t launch_walk(const Query& q, bool any, const float* o,
                        const float* d, const float* maxt,
                        const uint8_t* active, int n, float* t, int32_t* face,
                        uint8_t* occluded, unsigned* next_slot,
                        cudaStream_t stream, bool run, PersistentGrid& g) {
  const auto kernel =
      any ? &hit_kernel<true, Query> : &hit_kernel<false, Query>;
  const int max_blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  const cudaError_t err = persistent_grid(kernel, THREADS, 0, max_blocks, g);
  if (err != cudaSuccess || !run) return err;
  kernel<<<g.blocks, THREADS, 0, stream>>>(q, o, d, maxt, active, n, t, face,
                                           occluded, next_slot);
  return cudaGetLastError();
}

// launch_walk with the walk a tree `depth` deep takes.
cudaError_t launch(bool any, int depth, const float* node_box,
                   const int32_t* node_meta, const float* node_pair,
                   const float* leaf_geo, const int32_t* leaf_face,
                   const float* o, const float* d, const float* maxt,
                   const uint8_t* active, int n, float* t, int32_t* face,
                   uint8_t* occluded, unsigned* next_slot,
                   cudaStream_t stream, bool run, PersistentGrid& g) {
  if (pair_route(depth))
    return launch_walk(
        PairQuery{reinterpret_cast<const float4*>(node_pair),
                  reinterpret_cast<const float4*>(leaf_geo), leaf_face},
        any, o, d, maxt, active, n, t, face, occluded, next_slot, stream,
        run, g);
  return launch_walk(make_query(node_box, node_meta, leaf_geo, leaf_face),
                     any, o, d, maxt, active, n, t, face, occluded, next_slot,
                     stream, run, g);
}

}  // namespace

// Both launch a persistent grid on `stream` over n rays, allocate nothing
// and do not synchronise; each returns the first CUDA error of its set-up
// or launch.  The tables come from ops/traverse.py::pack_bvh_geometry:
// node_box (M, 8), node_pair (R, 16) (ops/bvh.py pack_node_pairs) and
// leaf_geo (P, 12) float32, node_meta (M, 4) and leaf_face (P,) int32,
// all 16-byte aligned; `depth` is the tree's (BVH.depth), which picks the
// walk: the pair walk over node_pair up to PAIR_STACK, else the miss-link
// walk over node_box and node_meta.  o, d (n, 3) and maxt (n,) float32,
// active (n,) bool.  `next_slot` is one zeroed uint32 of device memory,
// the schedule's counter (it ends past n).

// Closest hit: t (n,) (inf on a miss or an inactive ray), face (n,) (-1).
extern "C" int packet_closest_hit(const float* node_box,
                                  const int32_t* node_meta,
                                  const float* node_pair,
                                  const float* leaf_geo,
                                  const int32_t* leaf_face, int depth,
                                  const float* o, const float* d,
                                  const float* maxt, const uint8_t* active,
                                  int n, float* t, int32_t* face,
                                  unsigned* next_slot, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PersistentGrid g;
  return (int)launch(false, depth, node_box, node_meta, node_pair, leaf_geo,
                     leaf_face, o, d, maxt, active, n, t, face, nullptr,
                     next_slot, (cudaStream_t)stream, true, g);
}

// Any hit: occluded (n,) bool, false for an inactive ray.
extern "C" int packet_any_hit(const float* node_box, const int32_t* node_meta,
                              const float* node_pair, const float* leaf_geo,
                              const int32_t* leaf_face, int depth,
                              const float* o, const float* d,
                              const float* maxt, const uint8_t* active, int n,
                              uint8_t* occluded, unsigned* next_slot,
                              void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PersistentGrid g;
  return (int)launch(true, depth, node_box, node_meta, node_pair, leaf_geo,
                     leaf_face, o, d, maxt, active, n, nullptr, nullptr,
                     occluded, next_slot, (cudaStream_t)stream, true, g);
}

// The launch the closest (any = 0) or any-hit (any = 1) query makes over
// n rays of a tree `depth` deep, in cfg[0..6]: blocks, resident blocks per
// SM, threads a block, SMs, ray slots a warp takes at once, the deepest
// tree the pair walk takes, and the route (1: the pair walk, 0: the
// miss-link walk).
extern "C" int packet_hit_config(int n, int depth, int any, int* cfg) {
  PersistentGrid g{0, 0, 0, 0};
  const cudaError_t err =
      n > 0 ? launch(any != 0, depth, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, n, nullptr,
                     nullptr, nullptr, nullptr, nullptr, false, g)
            : cudaSuccess;
  cfg[0] = g.blocks;
  cfg[1] = g.resident;
  cfg[2] = g.threads;
  cfg[3] = g.sms;
  cfg[4] = CHUNK;
  cfg[5] = PAIR_STACK;
  cfg[6] = pair_route(depth) ? 1 : 0;
  return (int)err;
}
