// Shared by the two brute-force kernels (sm_90a), csrc/intersect_packed.cu
// and csrc/megakernel.cu: the faces staged in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace mk {

// Stages face j's p0, e1, e2 (component c at tris[c * comp_stride + j *
// face_stride]) as one 12-float row [p0 | e1 | e2 | 0 0 0]: three float4
// that every thread of a warp reads at once, as 128-bit broadcasts.
__device__ __forceinline__ void stage_face_rows(float4* geo,
                                                const float* __restrict__ tris,
                                                int n_faces, int face_stride,
                                                int comp_stride) {
  float* g = reinterpret_cast<float*>(geo);
  for (int k = threadIdx.x; k < 12 * n_faces; k += blockDim.x) {
    const int j = k / 12, c = k % 12;
    g[k] = c < 9 ? tris[c * comp_stride + j * face_stride] : 0.0f;
  }
}

// Face j of the staged rows as tri_test's 9 floats.
__device__ __forceinline__ void load_face(const float4* geo, int j,
                                          float (&g)[9]) {
  const float4 a = geo[3 * j], b = geo[3 * j + 1], c = geo[3 * j + 2];
  g[0] = a.x;
  g[1] = a.y;
  g[2] = a.z;
  g[3] = a.w;
  g[4] = b.x;
  g[5] = b.y;
  g[6] = b.z;
  g[7] = b.w;
  g[8] = c.x;
}

}  // namespace mk
