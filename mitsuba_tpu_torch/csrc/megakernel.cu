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
// Design, simple first:
// - one thread per lane; the whole bounce loop runs in registers and a
//   lane leaves the loop as soon as its path ends;
// - the depth loop is a runtime loop, not unrolled: per-depth conditions
//   are integer compares, and one copy of the large body keeps the
//   instruction footprint small;
// - each block stages the faces' p0/e1/e2 (9 floats a face, 36 KB at the
//   1024-face cap) and the light table in shared memory; every thread of
//   a warp reads the same face at once, so the reads are broadcasts;
// - the closest-hit sweep carries only (best t, best index); the
//   winner's shading attributes are read from global memory after it;
// - the shadow ray stops at its first occluder;
// - the bounce body is csrc/path_common.cuh's `bounce`, shared with the
//   BVH kernels of csrc/megakernel_bvh.cu; this file only supplies the
//   brute-force hit query over the staged faces.

#include "path_common.cuh"

namespace {

using namespace mk;

constexpr int GEO_COLS = 9;  // p0, e1, e2 staged in shared memory
constexpr int THREADS = 128;

// Hit queries over every staged face: strict < keeps the LOWEST index
// among equal t; the shadow ray stops at its first occluder.
struct BruteQuery {
  const float* geo;
  int n_faces;

  __device__ __forceinline__ int closest(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& t) const {
    t = CUDART_INF_F;
    int best = -1;
    for (int j = 0; j < n_faces; ++j) {
      float tj;
      if (tri_test(geo + j * GEO_COLS, ox, oy, oz, dx, dy, dz, t, tj) &&
          tj < t) {
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
      float tj;
      if (tri_test(geo + j * GEO_COLS, ox, oy, oz, dx, dy, dz, maxt, tj))
        return true;
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
                        float* __restrict__ out) {
  extern __shared__ float smem[];
  float* geo = smem;                          // n_faces * GEO_COLS
  float* lt = smem + n_faces * GEO_COLS;      // n_lights * LIGHT_COLS
  for (int k = threadIdx.x; k < n_faces * GEO_COLS; k += blockDim.x)
    geo[k] = tris[(k / GEO_COLS) * TRI_COLS + k % GEO_COLS];
  stage_light(lt, light, n_lights);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  PathState s = primary_state(o, d, active, i);
  trace_path(BruteQuery{geo, n_faces}, tris, lt, n_lights, smooth != 0,
             seed ^ 0xDEADBEEFu, (uint32_t)lanes[i], max_depth, rr_depth, s);
  out[3 * i] = s.Lr;
  out[3 * i + 1] = s.Lg;
  out[3 * i + 2] = s.Lb;
}

}  // namespace

// Launches the kernel on `stream` over n lanes; allocates nothing and
// does not synchronise.  Returns cudaGetLastError() of the launch.
extern "C" int megakernel_trace(const float* tris, int n_faces,
                                const float* light, int n_lights,
                                const int32_t* lanes, const float* o,
                                const float* d, const uint8_t* active,
                                uint32_t seed, int max_depth, int rr_depth,
                                int smooth, int n, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem =
      (size_t)(n_faces * GEO_COLS + n_lights * LIGHT_COLS) * sizeof(float);
  megakernel_trace_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tris, n_faces, light, n_lights, lanes, o, d, active, seed, max_depth,
      rr_depth, smooth, n, out);
  return (int)cudaGetLastError();
}
