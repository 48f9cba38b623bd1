// BVH path-tracing kernels for NVIDIA Hopper (sm_90a).
//
// Replace, for the constant-diffuse specialisation (btypes == (0,),
// flat or smooth shading normals, no texture, no envmap):
// - mitsuba_tpu/ops/pallas/megakernel.py::megakernel_bounce_bvh (:2206,
//   _mk_bounce_kernel_bvh :2017): ONE bounce over the 16-float per-lane
//   state, launched once per depth by megapath._sorted_bvh with the lanes
//   re-sorted in between;
// - megakernel.py::megakernel_trace_bvh (:1931, _mk_kernel_bvh :1671):
//   the same bounce looped over every depth in one launch.
// Both run csrc/path_common.cuh's `bounce`, the body of the brute
// kernel in csrc/megakernel.cu, with a BVH hit query in place of the
// sweep over every face.
//
// What bounds them on this card: counted as work, operations for the
// single launch (box and triangle tests: ~6e9 float operations a frame at
// 82k faces, 256x256 x 16 spp) and bytes for the bounce kernel (a live
// lane's 64-byte state passes in and out at each of up to six launches,
// a dead lane reads only its act flag).  Both
// run far above that bound, because the walk is a chain of dependent
// loads (node -> next node) that diverges across a warp: lanes visit
// different nodes and different counts of them.  The tables (about 0.6
// nodes a face at 48 bytes, 48 bytes a leaf slot, 156 bytes a face row:
// ~20 MB at 82k faces) stay in the 50 MB L2.
//
// Design, simple first:
// - one thread per lane; the state is SoA (16, N), so each field is one
//   coalesced load and store.  megakernel_bounce_bvh updates the state
//   IN PLACE (each thread reads and then writes only its own lane); a
//   lane whose act is 0 returns at once, the counterpart of the TPU
//   kernel's per-tile skip flags;
// - the walk is csrc/bvh_walk.cuh's stackless miss-link walk, shared
//   with csrc/traverse.cu: node arrays and leaf triangles in global
//   memory, read through the read-only cache, no shared-memory staging
//   (at 82k faces the tables are megabytes); the closest walk carries
//   only (best t, best slot) and the winner's 39-column row (face order)
//   is read once after it; the shadow walk returns at its first
//   occluder.

#include "bvh_walk.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
megakernel_bounce_bvh_kernel(BvhQuery q, const float* __restrict__ tris,
                             const float* __restrict__ light, int n_lights,
                             const int32_t* __restrict__ lanes,
                             float* __restrict__ state, int n, uint32_t seed,
                             int depth, int max_depth, int rr_depth,
                             int smooth) {
  __shared__ float lt[MAX_LIGHT_FACES * LIGHT_COLS];
  stage_light(lt, light, n_lights);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* st = state + i;  // field k of this lane at st[k * n]
  const size_t N = (size_t)n;
  if (!(st[15 * N] > 0.5f)) return;
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
  bounce(q, tris, lt, n_lights, smooth != 0, seed ^ 0xDEADBEEFu,
         (uint32_t)lanes[i], depth, max_depth, rr_depth, s);
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

__global__ void __launch_bounds__(THREADS)
megakernel_trace_bvh_kernel(BvhQuery q, const float* __restrict__ tris,
                            const float* __restrict__ light, int n_lights,
                            const int32_t* __restrict__ lanes,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            const uint8_t* __restrict__ active,
                            uint32_t seed, int max_depth, int rr_depth,
                            int smooth, int n, float* __restrict__ out) {
  __shared__ float lt[MAX_LIGHT_FACES * LIGHT_COLS];
  stage_light(lt, light, n_lights);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  PathState s = primary_state(o, d, active, i);
  trace_path(q, tris, lt, n_lights, smooth != 0, seed ^ 0xDEADBEEFu,
             (uint32_t)lanes[i], max_depth, rr_depth, s);
  out[3 * i] = s.Lr;
  out[3 * i + 1] = s.Lg;
  out[3 * i + 2] = s.Lb;
}

}  // namespace

// Both launch on `stream` over n lanes, allocate nothing and do not
// synchronise; each returns cudaGetLastError() of its launch.  The
// tables come from ops/megakernel_bvh.py::pack_scene_bvh: node_box (M, 8)
// and leaf_geo (P, 12) float32, node_meta (M, 4) and leaf_face (P,)
// int32, all 16-byte aligned; n_lights <= 16.

// One bounce at `depth`, updating the (16, n) state in place.
extern "C" int megakernel_bounce_bvh(const float* node_box,
                                     const int32_t* node_meta,
                                     const float* leaf_geo,
                                     const int32_t* leaf_face,
                                     const float* tris, const float* light,
                                     int n_lights, const int32_t* lanes,
                                     float* state, int n, uint32_t seed,
                                     int depth, int max_depth, int rr_depth,
                                     int smooth, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  megakernel_bounce_bvh_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      make_query(node_box, node_meta, leaf_geo, leaf_face), tris, light,
      n_lights, lanes, state, n, seed, depth, max_depth, rr_depth, smooth);
  return (int)cudaGetLastError();
}

// Every bounce in one launch: per-lane radiance out (n, 3).
extern "C" int megakernel_trace_bvh(const float* node_box,
                                    const int32_t* node_meta,
                                    const float* leaf_geo,
                                    const int32_t* leaf_face,
                                    const float* tris, const float* light,
                                    int n_lights, const int32_t* lanes,
                                    const float* o, const float* d,
                                    const uint8_t* active, uint32_t seed,
                                    int max_depth, int rr_depth, int smooth,
                                    int n, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  megakernel_trace_bvh_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      make_query(node_box, node_meta, leaf_geo, leaf_face), tris, light,
      n_lights, lanes, o, d, active, seed, max_depth, rr_depth, smooth, n,
      out);
  return (int)cudaGetLastError();
}
