// BVH path-tracing kernels for NVIDIA Hopper (sm_90a).
//
// Replace, for BSDF codes 0-7 and 16-23 (diffuse, bitmap-textured
// diffuse, smooth and GGX rough conductors, dielectrics and plastics, each
// also two-sided), flat or smooth shading normals and an area light:
// - mitsuba_tpu/ops/pallas/megakernel.py::megakernel_bounce_bvh (:2206,
//   _mk_bounce_kernel_bvh :2017): ONE bounce over the 16-float per-lane
//   state, launched once per depth by megapath._sorted_bvh with the lanes
//   re-sorted in between; it also takes a lat-long environment map, with
//   or without the area light (path_common.cuh's ENV builds);
// - megakernel.py::megakernel_trace_bvh (:1931, _mk_kernel_bvh :1671):
//   every bounce of a frame in one launch; as the TPU kernel, it takes no
//   texture arena and no environment map, so no textured code (the wrapper
//   refuses 5 and 21) and no environment.
// Both run csrc/path_common.cuh's `bounce`, the body of the brute
// kernel in csrc/megakernel.cu, with csrc/bvh_pair_walk.cuh's BVH hit
// query in place of the sweep over every face, and each has the same three
// builds as the brute kernel: the diffuse-only body (lobes = 0), the
// conductor and dielectric lobes (lobes = 1) and every ported surface
// (lobes = 2); the bounce kernel also the two environment-map builds (the
// diffuse-only and surface bodies with env = 1).
//
// What bounds them on this card: counted as work, operations for the
// single launch (box and triangle tests: ~6e9 float operations a frame at
// 82k faces, 256x256 x 16 spp) and bytes for the bounce kernel (a live
// lane's 64-byte state passes in and out at each of up to six launches,
// a dead lane reads only its act flag).  Both run far above that bound,
// because they wait: the walk is a chain of dependent loads (record ->
// child record) from L2, where the tables (~20 MB at 82k faces) stay,
// and it diverges across a warp, whose lanes visit different nodes and
// different counts of them; a warp of one lane a thread also lives as
// long as its longest path.
//
// Design:
// - the walk (bvh_pair_walk.cuh) fetches both children's boxes with one
//   record, which halves the dependent steps of a descent, and enters the
//   nearer child first, which lets the closest walk clip more boxes; it
//   returns the miss-link walk's (t, face) and occlusion;
// - megakernel_trace_bvh runs path_common.cuh's `trace_paths`: persistent
//   threads (as many blocks as the card holds at once) that take the next
//   unstarted slot from a counter when their path ends, so warps stay
//   full until the frame's slots run out;
// - megakernel_bounce_bvh runs the same persistent grid, and each warp
//   takes 32 consecutive lanes at a time from a counter (Aila & Laine's
//   persistent threads, HPG 2009), so no block waits on another warp's
//   long walk, and a chunk of dead lanes (the per-depth sort puts them at
//   the back) costs one coalesced read of act.  The state is SoA (16, N),
//   so each field is one coalesced load and store, and it is updated IN
//   PLACE: each thread reads and then writes only its own lane;
// - every random number is a pure function of (seed, lane id, dim), so
//   neither schedule changes a lane's result;
// - the light table is staged in shared memory; the closest walk carries
//   only (best t, best slot) and the winner's 39-column row (face order)
//   is read once after it; the shadow walk returns at its first occluder.

#include "bvh_pair_walk.cuh"
#include "persistent.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 128;
// 7 resident blocks a SM: ptxas keeps each kernel to 72 registers, with a
// few spills, where unbounded it takes 80 and 6 blocks fit; the walk's
// latency is hidden better (PERF.md)
constexpr int MIN_BLOCKS = 7;

template <int LOBES, bool ENV>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
megakernel_bounce_bvh_kernel(PairQuery q, const float* __restrict__ tris,
                             const float* __restrict__ light, int n_lights,
                             const float* __restrict__ tex, int n_tex,
                             const EnvMap env,
                             const int32_t* __restrict__ lanes,
                             float* __restrict__ state, int n, uint32_t seed,
                             int depth, int max_depth, int rr_depth,
                             int smooth, unsigned* __restrict__ next_lane) {
  __shared__ float lt[MAX_LIGHT_FACES * LIGHT_COLS];
  stage_light(lt, light, n_lights);
  __syncthreads();

  const unsigned lane_bit = threadIdx.x & 31;
  const size_t N = (size_t)n;
  for (;;) {
    unsigned base = 0;
    if (lane_bit == 0) base = atomicAdd(next_lane, 32u);
    base = __shfl_sync(FULL_MASK, base, 0);
    if (base >= (unsigned)n) return;
    const unsigned i = base + lane_bit;
    if (i >= (unsigned)n) continue;
    float* st = state + i;  // field k of this lane at st[k * n]
    if (!(st[15 * N] > 0.5f)) continue;
    PathState s;
    s.ox = st[0];
    s.oy = st[N];
    s.oz = st[2 * N];
    s.dx = st[3 * N];
    s.dy = st[4 * N];
    s.dz = st[5 * N];
    s.Lr = st[6 * N];
    s.Lg = st[7 * N];
    s.Lb = st[8 * N];
    s.Br = st[9 * N];
    s.Bg = st[10 * N];
    s.Bb = st[11 * N];
    s.eta = st[12 * N];
    s.prev_pdf = st[13 * N];
    s.prev_delta = st[14 * N] > 0.5f;
    s.act = true;
    bounce<LOBES, ENV>(q, tris, tex, n_tex, env, lt, n_lights, smooth != 0,
                       seed ^ 0xDEADBEEFu, (uint32_t)lanes[i], depth,
                       max_depth, rr_depth, s);
    st[0] = s.ox;
    st[N] = s.oy;
    st[2 * N] = s.oz;
    st[3 * N] = s.dx;
    st[4 * N] = s.dy;
    st[5 * N] = s.dz;
    st[6 * N] = s.Lr;
    st[7 * N] = s.Lg;
    st[8 * N] = s.Lb;
    st[9 * N] = s.Br;
    st[10 * N] = s.Bg;
    st[11 * N] = s.Bb;
    st[12 * N] = s.eta;
    st[13 * N] = s.prev_pdf;
    st[14 * N] = s.prev_delta ? 1.0f : 0.0f;
    st[15 * N] = s.act ? 1.0f : 0.0f;
  }
}

template <int LOBES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
megakernel_trace_bvh_kernel(PairQuery q, const float* __restrict__ tris,
                            const float* __restrict__ light, int n_lights,
                            const int32_t* __restrict__ lanes,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            const uint8_t* __restrict__ active,
                            uint32_t seed, int max_depth, int rr_depth,
                            int smooth, int n, float* __restrict__ out,
                            unsigned* __restrict__ next_slot) {
  __shared__ float lt[MAX_LIGHT_FACES * LIGHT_COLS];
  stage_light(lt, light, n_lights);
  __syncthreads();

  trace_paths<LOBES, false>(q, tris, nullptr, 0, EnvMap{}, lt, n_lights,
                            smooth != 0, seed, lanes, o, d, active,
                            max_depth, rr_depth, n, out, next_slot);
}

// Each kernel's build for `lobes` (0, 1 or 2), null for another value.
template <class Kernel>
Kernel pick(int lobes, Kernel diffuse, Kernel lobe, Kernel surface) {
  return lobes == DIFFUSE_BUILD   ? diffuse
         : lobes == LOBE_BUILD    ? lobe
         : lobes == SURFACE_BUILD ? surface
                                  : nullptr;
}

// The bounce kernel's build for `lobes` and `env`: with an environment
// map only the diffuse-only and surface builds exist.
auto bounce_kernel(int lobes, int env) {
  if (env)
    return pick(lobes, megakernel_bounce_bvh_kernel<DIFFUSE_BUILD, true>,
                decltype(&megakernel_bounce_bvh_kernel<DIFFUSE_BUILD, true>){},
                megakernel_bounce_bvh_kernel<SURFACE_BUILD, true>);
  return pick(lobes, megakernel_bounce_bvh_kernel<DIFFUSE_BUILD, false>,
              megakernel_bounce_bvh_kernel<LOBE_BUILD, false>,
              megakernel_bounce_bvh_kernel<SURFACE_BUILD, false>);
}

auto trace_kernel(int lobes) {
  return pick(lobes, megakernel_trace_bvh_kernel<DIFFUSE_BUILD>,
              megakernel_trace_bvh_kernel<LOBE_BUILD>,
              megakernel_trace_bvh_kernel<SURFACE_BUILD>);
}

PairQuery pair_query(const float* node_pair, const float* leaf_geo,
                     const int32_t* leaf_face) {
  return PairQuery{reinterpret_cast<const float4*>(node_pair),
                   reinterpret_cast<const float4*>(leaf_geo), leaf_face};
}

// The persistent grid of `kernel` over n > 0 lanes.
template <class Kernel>
cudaError_t grid_for(Kernel kernel, int n, PersistentGrid& g) {
  return persistent_grid(kernel, THREADS, 0, (n + THREADS - 1) / THREADS, g);
}

// cfg[0..4]: blocks, resident blocks per SM, threads a block, SMs, and the
// deepest tree the walk takes.
template <class Kernel>
int write_config(Kernel kernel, int n, int* cfg) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  PersistentGrid g{0, 0, 0, 0};
  const cudaError_t err = n > 0 ? grid_for(kernel, n, g) : cudaSuccess;
  cfg[0] = g.blocks;
  cfg[1] = g.resident;
  cfg[2] = g.threads;
  cfg[3] = g.sms;
  cfg[4] = PAIR_STACK;
  return (int)err;
}

}  // namespace

// Both launch a persistent grid on `stream` over n lanes, allocate nothing
// and do not synchronise; each returns the first CUDA error of its set-up
// or launch.  The tables come from ops/megakernel_bvh.py::pack_scene_bvh:
// node_pair (R, 16) (ops/bvh.py pack_node_pairs; its tree no deeper than
// cfg[4] of the *_config entries) and leaf_geo (P, 12) float32, leaf_face
// (P,) int32, all 16-byte aligned; n_lights <= 16.  `next_slot` is one
// zeroed uint32 of device memory, the schedule's counter (it ends past n).

// `lobes` picks the build: 0 the diffuse-only body, 1 the conductor and
// dielectric lobes, 2 every ported surface.

// One bounce at `depth`, updating the (16, n) state in place; `tex` is
// the texture arena of n_tex floats, null and 0 without one; `env`,
// `n_env`, `env_meta` and `env_pos` the environment map as in
// csrc/megakernel.cu's megakernel_trace (null, 0, null, -1 without one).
extern "C" int megakernel_bounce_bvh(const float* node_pair,
                                     const float* leaf_geo,
                                     const int32_t* leaf_face,
                                     const float* tris, const float* light,
                                     int n_lights, const float* tex,
                                     int n_tex, const float* env, int n_env,
                                     const float* env_meta, int env_pos,
                                     const int32_t* lanes, float* state,
                                     int n, uint32_t seed, int depth,
                                     int max_depth, int rr_depth, int smooth,
                                     int lobes, unsigned* next_slot,
                                     void* stream) {
  EnvMap e;
  if (!env_map(env, n_env, env_meta, env_pos, e))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const auto kernel = bounce_kernel(lobes, env != nullptr);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  PersistentGrid g;
  const cudaError_t err = grid_for(kernel, n, g);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, THREADS, 0, (cudaStream_t)stream>>>(
      pair_query(node_pair, leaf_geo, leaf_face), tris, light, n_lights, tex,
      n_tex, e, lanes, state, n, seed, depth, max_depth, rr_depth, smooth,
      next_slot);
  return (int)cudaGetLastError();
}

// Every bounce in one launch: per-lane radiance out (n, 3).
extern "C" int megakernel_trace_bvh(const float* node_pair,
                                    const float* leaf_geo,
                                    const int32_t* leaf_face,
                                    const float* tris, const float* light,
                                    int n_lights, const int32_t* lanes,
                                    const float* o, const float* d,
                                    const uint8_t* active, uint32_t seed,
                                    int max_depth, int rr_depth, int smooth,
                                    int lobes, int n, float* out,
                                    unsigned* next_slot, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto kernel = trace_kernel(lobes);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  PersistentGrid g;
  const cudaError_t err = grid_for(kernel, n, g);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, THREADS, 0, (cudaStream_t)stream>>>(
      pair_query(node_pair, leaf_geo, leaf_face), tris, light, n_lights,
      lanes, o, d, active, seed, max_depth, rr_depth, smooth, n, out,
      next_slot);
  return (int)cudaGetLastError();
}

// The launch each kernel's build `lobes` (and, for the bounce kernel,
// `env`: 1 with an environment map) makes over n lanes, in cfg[0..4]:
// blocks, resident blocks per SM, threads a block, SMs, and the deepest
// tree the walk takes.
extern "C" int megakernel_bounce_bvh_config(int n, int lobes, int env,
                                            int* cfg) {
  return write_config(bounce_kernel(lobes, env), n, cfg);
}

extern "C" int megakernel_trace_bvh_config(int n, int lobes, int env,
                                           int* cfg) {
  return write_config(env ? nullptr : trace_kernel(lobes), n, cfg);
}
