// Path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces mitsuba_tpu/ops/pallas/megakernel.py::megakernel_trace (the
// Pallas kernel _mk_kernel with _trace_loop/_bounce_step) for its
// constant-diffuse specialisation: btypes == (0,), flat or smooth
// shading normals, no texture, no envmap.  It reads the same packed
// tables pack_scene makes (39-column triangle rows, 17-column light
// rows), so further lobes only extend the body.
//
// What bounds it: FP32 arithmetic, not bytes.  Each lane reads 29 bytes
// and writes 12, but every bounce tests the ray against every face twice
// (closest hit, then the shadow ray), about 53 floating-point operations
// per test.  On the Cornell box (36 faces) that is ~10^10 to 10^11
// operations per frame against ~0.2 GB of traffic.
//
// Design: persistent threads with path regeneration.
// - As many blocks as the card holds at once (SMs x resident blocks from
//   the occupancy calculator).  Each thread holds one path at a time: its
//   slot, its depth and its PathState, all in registers.
// - At each step every thread that holds a path runs one `bounce` at its
//   own depth.  When a path ends (miss, back face, russian roulette,
//   max_depth, or an input slot that is not active) the thread writes
//   its radiance, and the finished lanes of the warp take the next
//   unstarted slots with one atomicAdd on a counter in device memory (the
//   wrapper's scratch): the ballot of the finished lanes gives the count,
//   each lane's rank in it the offset.  So warps stay full until the
//   frame's slots run out, instead of idling until their longest path
//   ends.  A warp leaves when no lane holds a path and the counter has
//   passed n.
// - Every random number is a pure function of (seed, lane id, dim), so a
//   slot's radiance does not depend on which thread traces it, or when:
//   it is the one-thread-per-slot kernel's, bit for bit.
// - Each block stages the faces' p0/e1/e2 in shared memory, one 12-float
//   row a face [p0 | e1 | e2 | 0 0 0] read as three 128-bit broadcasts,
//   and the light table; the closest-hit sweep carries only (best t,
//   best index), the winner's shading attributes are read from global
//   memory after it, and the shadow ray stops at its first occluder.
// - The bounce body is csrc/path_common.cuh's `bounce`, shared with the
//   BVH kernels of csrc/megakernel_bvh.cu; this file supplies the
//   brute-force hit query over the staged faces and the schedule.

#include "path_common.cuh"
#include "brute_common.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Hit queries over every staged face: strict < keeps the LOWEST index
// among equal t; the shadow ray stops at its first occluder.
struct BruteQuery {
  const float4* geo;  // 3 per face
  int n_faces;

  __device__ __forceinline__ int closest(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& t) const {
    t = CUDART_INF_F;
    int best = -1;
    for (int j = 0; j < n_faces; ++j) {
      float g[9], tj;
      load_face(geo, j, g);
      if (tri_test(g, ox, oy, oz, dx, dy, dz, t, tj) && tj < t) {
        t = tj;
        best = j;
      }
    }
    return best;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float maxt) const {
    for (int j = 0; j < n_faces; ++j) {
      float g[9], tj;
      load_face(geo, j, g);
      if (tri_test(g, ox, oy, oz, dx, dy, dz, maxt, tj)) return true;
    }
    return false;
  }
};

__global__ void __launch_bounds__(THREADS)
megakernel_trace_kernel(const float* __restrict__ tris, int n_faces,
                        const float* __restrict__ light, int n_lights,
                        const int32_t* __restrict__ lanes,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const uint8_t* __restrict__ active, uint32_t seed,
                        int max_depth, int rr_depth, int smooth, int n,
                        float* __restrict__ out,
                        unsigned* __restrict__ next_slot) {
  extern __shared__ float4 smem[];
  float4* geo = smem;                                   // 3 per face
  float* lt = reinterpret_cast<float*>(smem + 3 * n_faces);  // L x LIGHT_COLS
  stage_face_rows(geo, tris, n_faces, TRI_COLS, 1);
  stage_light(lt, light, n_lights);
  __syncthreads();

  const BruteQuery q{geo, n_faces};
  const uint32_t seed_x = seed ^ 0xDEADBEEFu;
  const unsigned lane_bit = threadIdx.x & 31;
  int slot = 0, depth = 0;
  uint32_t lane_id = 0;
  bool have = false;  // holds a path
  bool done = false;  // the counter has passed n for this thread
  PathState s;
  for (;;) {
    // the lanes without a path take the next slots, one atomicAdd a warp,
    // until each holds a path or the slots have run out
    for (unsigned want; (want = __ballot_sync(FULL_MASK, !have && !done));) {
      const int leader = __ffs(want) - 1;
      unsigned base = 0;
      if ((int)lane_bit == leader)
        base = atomicAdd(next_slot, (unsigned)__popc(want));
      base = __shfl_sync(FULL_MASK, base, leader);
      if (!have && !done) {
        const unsigned k = base + __popc(want & ((1u << lane_bit) - 1u));
        if (k >= (unsigned)n) {
          done = true;
        } else {
          slot = (int)k;
          s = primary_state(o, d, active, slot);
          lane_id = (uint32_t)lanes[slot];
          depth = 0;
          have = s.act && max_depth > 0;
          if (!have) {  // an inactive slot: no bounce, L = 0
            out[3 * slot] = s.Lr;
            out[3 * slot + 1] = s.Lg;
            out[3 * slot + 2] = s.Lb;
          }
        }
      }
    }
    if (!__any_sync(FULL_MASK, have)) break;
    if (have) {
      bounce(q, tris, lt, n_lights, smooth != 0, seed_x, lane_id, depth,
             max_depth, rr_depth, s);
      if (!s.act || ++depth >= max_depth) {
        out[3 * slot] = s.Lr;
        out[3 * slot + 1] = s.Lg;
        out[3 * slot + 2] = s.Lb;
        have = false;
      }
    }
  }
}

size_t smem_bytes(int n_faces, int n_lights) {
  return sizeof(float4) * 3 * (size_t)n_faces +
         sizeof(float) * (size_t)n_lights * LIGHT_COLS;
}

}  // namespace

// Launches the kernel on `stream` over n lanes; allocates nothing and
// does not synchronise.  `next_slot` is one zeroed uint32 of device
// memory, the schedule's counter (it ends at or past n).  Returns the
// first CUDA error of the set-up or the launch.
extern "C" int megakernel_trace(const float* tris, int n_faces,
                                const float* light, int n_lights,
                                const int32_t* lanes, const float* o,
                                const float* d, const uint8_t* active,
                                uint32_t seed, int max_depth, int rr_depth,
                                int smooth, int n, float* out,
                                unsigned* next_slot, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(n_faces, n_lights);
  PersistentGrid g;
  const cudaError_t err = persistent_grid(
      megakernel_trace_kernel, THREADS, smem, (n + THREADS - 1) / THREADS, g);
  if (err != cudaSuccess) return (int)err;
  megakernel_trace_kernel<<<g.blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tris, n_faces, light, n_lights, lanes, o, d, active, seed, max_depth,
      rr_depth, smooth, n, out, next_slot);
  return (int)cudaGetLastError();
}

// The launch megakernel_trace makes for these sizes, in cfg[0..3]:
// blocks, resident blocks per SM, threads a block, SMs.
extern "C" int megakernel_trace_config(int n_faces, int n_lights, int n,
                                       int* cfg) {
  PersistentGrid g{0, 0, 0, 0};
  const cudaError_t err =
      n > 0 ? persistent_grid(megakernel_trace_kernel, THREADS,
                              smem_bytes(n_faces, n_lights),
                              (n + THREADS - 1) / THREADS, g)
            : cudaSuccess;
  cfg[0] = g.blocks;
  cfg[1] = g.resident;
  cfg[2] = g.threads;
  cfg[3] = g.sms;
  return (int)err;
}
