// Brute-force closest hit over a packed face table, for NVIDIA Hopper
// (sm_90a).
//
// Replaces mitsuba_tpu/ops/pallas/intersect_pallas.py::intersect_packed
// (:125, Pallas kernel _kernel :51): for each ray, the closest face of a
// (9, F) table [p0 | e1 | e2] (pack_triangles) within 0 < t <= maxt,
// with its barycentrics.  The wavefront PathIntegrator queries it twice a
// depth on scenes of at most 1024 faces: closest hit, then shadow rays.
//
// What bounds it on this card: FP32 arithmetic.  Every ray tests every
// face (about 53 floating-point operations a test) and moves 29 bytes in
// and 16 out; at 36 faces that is ~1900 operations against 45 bytes.
//
// Design, simple first:
// - one thread per ray; each block stages the faces in shared memory,
//   one 9-float row a face (36 bytes a face, 36 KB at the 1024-face cap),
//   and every thread of a warp reads the same face at once, so reads
//   broadcast;
// - a lane that the active mask leaves out writes a miss and stops;
// - the tie rule is the TPU kernel's, which reduces each 128-face block
//   to its smallest t and keeps the LARGEST index among equal t there,
//   then keeps an earlier block's hit unless a later block is strictly
//   closer.  Swept face by face: face j replaces the best bj if t < bt,
//   or if t == bt and j and bj lie in one 128-face block;
// - u and v are the winner's own (the TPU kernel sums them over a
//   one-hot of the winner);
// - the test is csrc/path_common.cuh's tri_test<true>, the megakernels'
//   arithmetic, built with -fmad=false.

#include "path_common.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 256;
constexpr int T_BLOCK_SHIFT = 7;  // 128-face blocks of the tie rule

__global__ void __launch_bounds__(THREADS)
intersect_packed_kernel(const float* __restrict__ tris, int n_faces,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ maxt,
                        const uint8_t* __restrict__ active, int n,
                        float* __restrict__ t_out, int32_t* __restrict__ prim,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float geo[];  // n_faces rows of 9: [p0 | e1 | e2]
  for (int k = threadIdx.x; k < 9 * n_faces; k += blockDim.x)
    geo[(k % n_faces) * 9 + k / n_faces] = tris[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = CUDART_INF_F, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  if (active[i]) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float mt = maxt[i];
    for (int j = 0; j < n_faces; ++j) {
      float t, u, v;
      const bool hit = tri_test<true>(geo + 9 * j, ox, oy, oz, dx, dy, dz,
                                      mt, t, &u, &v);
      if (hit && (t < bt || (t == bt && (j >> T_BLOCK_SHIFT) ==
                                            (bj >> T_BLOCK_SHIFT)))) {
        bt = t;
        bj = j;
        bu = u;
        bv = v;
      }
    }
  }
  t_out[i] = bt;
  prim[i] = bj;
  u_out[i] = bu;
  v_out[i] = bv;
}

}  // namespace

// Launches the kernel on `stream` over n rays; allocates nothing and does
// not synchronise.  tris is (9, n_faces) float32 with n_faces <= 1024;
// o, d (n, 3) and maxt (n,) float32; active (n,) bool.  Outputs (n,):
// t (inf on a miss or an inactive ray), prim (-1), u, v.
// Returns cudaGetLastError() of the launch.
extern "C" int intersect_packed(const float* tris, int n_faces,
                                const float* o, const float* d,
                                const float* maxt, const uint8_t* active,
                                int n, float* t, int32_t* prim, float* u,
                                float* v, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = (size_t)9 * n_faces * sizeof(float);
  intersect_packed_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tris, n_faces, o, d, maxt, active, n, t, prim, u, v);
  return (int)cudaGetLastError();
}
