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
// carried over.  These walk the port's SAH tree, one ray per thread, with
// csrc/bvh_walk.cuh's miss-link walk, the walk of the BVH megakernels.
// Ties therefore follow ops/bvh.py's walk (first in DFS order among equal
// t), not the packet tree's.
//
// What bounds them on this card: operations (box and triangle tests).
// Both run far above that bound: the walk is a chain of dependent loads
// that diverges across a warp.  The tables (about 7 MB at 82k faces) stay in
// the 50 MB L2.
//
// Design, simple first:
// - one thread per ray; an inactive ray writes a miss and stops;
// - the closest walk keeps the megakernels' walk untouched, which clips
//   box tests at min(best, maxt) but accepts a triangle hit below the
//   best alone; a hit beyond maxt is dropped afterwards.  That gives
//   ops/bvh.py's answer: every box the plain walk tests is tested, and
//   the closest hit within maxt is the closest hit of all tests when it
//   lies within maxt;
// - the any-hit walk returns at its first occluder.

#include "bvh_walk.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(BvhQuery q, const float* __restrict__ o,
                   const float* __restrict__ d,
                   const float* __restrict__ maxt,
                   const uint8_t* __restrict__ active, int n,
                   float* __restrict__ t_out, int32_t* __restrict__ face) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = CUDART_INF_F;
  int f = -1;
  if (active[i]) {
    const float mt = maxt[i];
    const int s = q.walk<false>(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                d[3 * i], d[3 * i + 1], d[3 * i + 2], mt, t);
    if (s >= 0 && t <= mt) {
      f = __ldg(q.face + s);
    } else {
      t = CUDART_INF_F;
    }
  }
  t_out[i] = t;
  face[i] = f;
}

__global__ void __launch_bounds__(THREADS)
any_hit_kernel(BvhQuery q, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ maxt,
               const uint8_t* __restrict__ active, int n,
               uint8_t* __restrict__ occluded) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  occluded[i] = active[i] && q.occluded(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                        d[3 * i], d[3 * i + 1], d[3 * i + 2],
                                        maxt[i]);
}

}  // namespace

// Both launch on `stream` over n rays, allocate nothing and do not
// synchronise; each returns cudaGetLastError() of its launch.  The tables
// come from ops/traverse.py::pack_bvh_geometry: node_box (M, 8) and
// leaf_geo (P, 12) float32, node_meta (M, 4) and leaf_face (P,) int32,
// all 16-byte aligned.  o, d (n, 3) and maxt (n,) float32, active (n,)
// bool.

// Closest hit: t (n,) (inf on a miss or an inactive ray), face (n,) (-1).
extern "C" int packet_closest_hit(const float* node_box,
                                  const int32_t* node_meta,
                                  const float* leaf_geo,
                                  const int32_t* leaf_face, const float* o,
                                  const float* d, const float* maxt,
                                  const uint8_t* active, int n, float* t,
                                  int32_t* face, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  closest_hit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      make_query(node_box, node_meta, leaf_geo, leaf_face), o, d, maxt,
      active, n, t, face);
  return (int)cudaGetLastError();
}

// Any hit: occluded (n,) bool, false for an inactive ray.
extern "C" int packet_any_hit(const float* node_box, const int32_t* node_meta,
                              const float* leaf_geo, const int32_t* leaf_face,
                              const float* o, const float* d,
                              const float* maxt, const uint8_t* active, int n,
                              uint8_t* occluded, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  any_hit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      make_query(node_box, node_meta, leaf_geo, leaf_face), o, d, maxt,
      active, n, occluded);
  return (int)cudaGetLastError();
}
