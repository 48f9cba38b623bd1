// Path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces mitsuba_tpu/ops/pallas/megakernel.py::megakernel_trace (the
// Pallas kernel _mk_kernel with _trace_loop/_bounce_step) for BSDF codes
// 0-4 (diffuse, smooth and GGX rough conductors and dielectrics), flat or
// smooth shading normals, no texture, no envmap.  It reads the same
// packed tables pack_scene makes (39-column triangle rows, 17-column
// light rows).  Two builds of the kernel, by the lobe set of
// path_common.cuh's `bounce`: the diffuse-only body (lobes = 0, btypes ==
// (0,)) and the body with every ported lobe (lobes = 1).
//
// What bounds it: FP32 arithmetic, not bytes.  Each lane reads 29 bytes
// and writes 12, but every bounce tests the ray against every face twice
// (closest hit, then the shadow ray), about 53 floating-point operations
// per test.  On the Cornell box (36 faces) that is ~10^10 to 10^11
// operations per frame against ~0.2 GB of traffic.
//
// Design: persistent threads with path regeneration (path_common.cuh
// `trace_paths`).
// - As many blocks as the card holds at once (SMs x resident blocks from
//   the occupancy calculator).  Each thread holds one path at a time; when
//   it ends, the thread takes the next unstarted slot from a counter in
//   device memory (the wrapper's scratch), one atomicAdd a warp.  So
//   warps stay full until the frame's slots run out, instead of idling
//   until their longest path ends.
// - Every random number is a pure function of (seed, lane id, dim), so a
//   slot's radiance does not depend on which thread traces it, or when:
//   it is the one-thread-per-slot kernel's, bit for bit.
// - Each block stages the faces' p0/e1/e2 in shared memory, one 12-float
//   row a face [p0 | e1 | e2 | 0 0 0] read as three 128-bit broadcasts,
//   and the light table; the closest-hit sweep carries only (best t,
//   best index), the winner's shading attributes are read from global
//   memory after it, and the shadow ray stops at its first occluder.
// - The bounce body is csrc/path_common.cuh's `bounce` and the schedule
//   its `trace_paths`, both shared with the BVH kernels of
//   csrc/megakernel_bvh.cu; this file supplies the brute-force hit query
//   over the staged faces.

#include "path_common.cuh"
#include "brute_common.cuh"
#include "persistent.cuh"

namespace {

using namespace mk;

constexpr int THREADS = 128;

size_t smem_bytes(int n_faces, int n_lights) {
  return sizeof(float4) * 3 * (size_t)n_faces +
         sizeof(float) * (size_t)n_lights * LIGHT_COLS;
}

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

template <bool LOBES>
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

  trace_paths<LOBES>(BruteQuery{geo, n_faces}, tris, lt, n_lights,
                     smooth != 0, seed, lanes, o, d, active, max_depth,
                     rr_depth, n, out, next_slot);
}

template <bool LOBES>
cudaError_t launch(const float* tris, int n_faces, const float* light,
                   int n_lights, const int32_t* lanes, const float* o,
                   const float* d, const uint8_t* active, uint32_t seed,
                   int max_depth, int rr_depth, int smooth, int n, float* out,
                   unsigned* next_slot, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_faces, n_lights);
  PersistentGrid g;
  const cudaError_t err =
      persistent_grid(megakernel_trace_kernel<LOBES>, THREADS, smem,
                      (n + THREADS - 1) / THREADS, g);
  if (err != cudaSuccess) return err;
  megakernel_trace_kernel<LOBES><<<g.blocks, THREADS, smem, stream>>>(
      tris, n_faces, light, n_lights, lanes, o, d, active, seed, max_depth,
      rr_depth, smooth, n, out, next_slot);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` over n lanes, the build of `lobes` (0:
// diffuse only, 1: every ported lobe); allocates nothing and does not
// synchronise.  `next_slot` is one zeroed uint32 of device memory, the
// schedule's counter (it ends at or past n).  Returns the first CUDA
// error of the set-up or the launch.
extern "C" int megakernel_trace(const float* tris, int n_faces,
                                const float* light, int n_lights,
                                const int32_t* lanes, const float* o,
                                const float* d, const uint8_t* active,
                                uint32_t seed, int max_depth, int rr_depth,
                                int smooth, int lobes, int n, float* out,
                                unsigned* next_slot, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto go = lobes ? launch<true> : launch<false>;
  return (int)go(tris, n_faces, light, n_lights, lanes, o, d, active, seed,
                 max_depth, rr_depth, smooth, n, out, next_slot,
                 (cudaStream_t)stream);
}

// The launch megakernel_trace makes for these sizes and `lobes`, in
// cfg[0..3]: blocks, resident blocks per SM, threads a block, SMs.
extern "C" int megakernel_trace_config(int n_faces, int n_lights, int n,
                                       int lobes, int* cfg) {
  PersistentGrid g{0, 0, 0, 0};
  const cudaError_t err =
      n > 0 ? persistent_grid(lobes ? megakernel_trace_kernel<true>
                                    : megakernel_trace_kernel<false>,
                              THREADS, smem_bytes(n_faces, n_lights),
                              (n + THREADS - 1) / THREADS, g)
            : cudaSuccess;
  cfg[0] = g.blocks;
  cfg[1] = g.resident;
  cfg[2] = g.threads;
  cfg[3] = g.sms;
  return (int)err;
}
