// Path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces mitsuba_tpu/ops/pallas/megakernel.py::megakernel_trace (the
// Pallas kernel _mk_kernel with _trace_loop/_bounce_step) for its
// constant-diffuse specialisation: btypes == (0,), flat shading, no
// texture, no envmap.  It reads the same packed tables pack_scene makes
// (39-column triangle rows, 17-column light rows), so further lobes only
// extend the body.
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
// - the shadow ray stops at its first occluder.
//
// Numerics follow the JAX kernel operation for operation.  Build with
// -fmad=false and without fast math: sqrtf, 1.0f / sqrtf(x) for rsqrt,
// IEEE division, sinf/cosf.  The RNG (PCG3D over seed, lane, dim) is
// bit-exact with mitsuba_tpu/core/rng.py.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TRI_COLS = 39;
constexpr int LIGHT_COLS = 17;
constexpr int GEO_COLS = 9;  // p0, e1, e2 staged in shared memory
constexpr int THREADS = 128;

constexpr float DET_EPS = 1e-9f;
constexpr float RAY_EPS = 1e-4f;
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr float PI_4 = (float)(3.14159265358979323846 / 4.0);
constexpr float PI_2 = (float)(3.14159265358979323846 / 2.0);

// models/integrators/common.py dimension layout
constexpr uint32_t DIM_BOUNCE_BASE = 8;
constexpr uint32_t DIMS_PER_BOUNCE = 8;
constexpr uint32_t SLOT_EM_SELECT = 0;
constexpr uint32_t SLOT_EM_POS = 1;
constexpr uint32_t SLOT_BSDF_DIR = 3;
constexpr uint32_t SLOT_RR = 4;

// ---------------------------------------------------------------- RNG
__device__ __forceinline__ void pcg3d(uint32_t& v0, uint32_t& v1,
                                      uint32_t& v2) {
  v0 = v0 * 1664525u + 1013904223u;
  v1 = v1 * 1664525u + 1013904223u;
  v2 = v2 * 1664525u + 1013904223u;
  v0 += v1 * v2;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v0 += v1 * v2;
  v1 += v2 * v0;
  v2 += v0 * v1;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void rng2(uint32_t seed_x, uint32_t lane,
                                     uint32_t dim, float& u0, float& u1) {
  uint32_t v0 = lane, v1 = dim, v2 = seed_x;
  pcg3d(v0, v1, v2);
  u0 = to_unit(v0);
  u1 = to_unit(v1);
}

__device__ __forceinline__ float rng1(uint32_t seed_x, uint32_t lane,
                                      uint32_t dim) {
  float u0, u1;
  rng2(seed_x, lane, dim, u0, u1);
  return u0;
}

// ------------------------------------------------------------- geometry
// Moller-Trumbore against one staged face g = [p0 | e1 | e2].
__device__ __forceinline__ bool tri_test(const float* g, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float maxt, float& t) {
  const float p0x = g[0], p0y = g[1], p0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) > DET_EPS;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  return ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > 0.0f &&
         t <= maxt;
}

__device__ __forceinline__ float mis(float pa, float pb) {
  const float a2 = pa * pa;
  const float w = a2 / fmaxf(a2 + pb * pb, 1e-32f);
  return pa > 0.0f ? w : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
megakernel_trace_kernel(const float* __restrict__ tris, int n_faces,
                        const float* __restrict__ light, int n_lights,
                        const int32_t* __restrict__ lanes,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const uint8_t* __restrict__ active, uint32_t seed,
                        int max_depth, int rr_depth, int n,
                        float* __restrict__ out) {
  extern __shared__ float smem[];
  float* geo = smem;                          // n_faces * GEO_COLS
  float* lt = smem + n_faces * GEO_COLS;      // n_lights * LIGHT_COLS
  for (int k = threadIdx.x; k < n_faces * GEO_COLS; k += blockDim.x)
    geo[k] = tris[(k / GEO_COLS) * TRI_COLS + k % GEO_COLS];
  for (int k = threadIdx.x; k < n_lights * LIGHT_COLS; k += blockDim.x)
    lt[k] = light[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const uint32_t lane = (uint32_t)lanes[i];
  const uint32_t seed_x = seed ^ 0xDEADBEEFu;
  float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f;
  float Br = 1.0f, Bg = 1.0f, Bb = 1.0f;
  float prev_pdf = 1.0f;
  bool prev_delta = true;
  bool act = active[i] != 0;
  // emission of the single constant area light (pack_scene writes the
  // triangle table's emission column as exactly is_light * Le)
  const float Ler0 = n_lights > 0 ? lt[14] : 0.0f;
  const float Leg0 = n_lights > 0 ? lt[15] : 0.0f;
  const float Leb0 = n_lights > 0 ? lt[16] : 0.0f;

  for (int depth = 0; depth < max_depth && act; ++depth) {
    const uint32_t dbase = DIM_BOUNCE_BASE + (uint32_t)depth * DIMS_PER_BOUNCE;

    // ---- closest hit: strict < keeps the lowest index among equal t
    float t = CUDART_INF_F;
    int best = -1;
    for (int j = 0; j < n_faces; ++j) {
      float tj;
      if (tri_test(geo + j * GEO_COLS, ox, oy, oz, dx, dy, dz, t, tj) &&
          tj < t) {
        t = tj;
        best = j;
      }
    }
    if (!isfinite(t)) break;  // miss: nothing more reaches this lane

    const float* row = tris + best * TRI_COLS;
    const float e1x = row[3], e1y = row[4], e1z = row[5];
    const float e2x = row[6], e2y = row[7], e2z = row[8];
    const float Rr = row[9], Rg = row[10], Rb = row[11];
    const float IsL = row[15], PdfA = row[16];
    float ngx = e1y * e2z - e1z * e2y;
    float ngy = e1z * e2x - e1x * e2z;
    float ngz = e1x * e2y - e1y * e2x;
    {
      const float inv =
          1.0f / sqrtf(fmaxf(ngx * ngx + ngy * ngy + ngz * ngz, 1e-30f));
      ngx *= inv;
      ngy *= inv;
      ngz *= inv;
    }
    // flat shading: the shading normal is the geometric one
    const float shx = ngx, shy = ngy, shz = ngz;

    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    const float cos_wi = -(dx * shx + dy * shy + dz * shz);
    const float cos_geo = -(dx * ngx + dy * ngy + dz * ngz);
    const bool front = cos_wi > 0.0f;

    // ---- MIS'd radiance of a directly hit emitter (path.py:82)
    if (front && IsL > 0.5f) {
      const float dist2 = t * t;
      const float pdf_hit =
          cos_geo > 1e-6f ? PdfA * dist2 / fmaxf(cos_geo, 1e-6f) : 0.0f;
      const float m_h = prev_delta ? 1.0f : mis(prev_pdf, pdf_hit);
      Lr = Lr + Br * (IsL * Ler0) * m_h;
      Lg = Lg + Bg * (IsL * Leg0) * m_h;
      Lb = Lb + Bb * (IsL * Leb0) * m_h;
    }
    if (!front || depth + 1 >= max_depth) break;

    // spawn-ray offset scale (records.py spawn_ray)
    const float off =
        RAY_EPS * fmaxf(1.0f, fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz))));

    // Duff orthonormal frame (core/math.py coordinate_system)
    const float sign = shz >= 0.0f ? 1.0f : -1.0f;
    const float a = -1.0f / (sign + shz);
    const float b = shx * shy * a;
    const float sx = 1.0f + sign * shx * shx * a, sy = sign * b,
                sz = -sign * shx;
    const float tx = b, ty = sign + shy * shy * a, tz = -shy;

    // ---- NEE toward the area light (path.py:92-105)
    {
      const float u_sel = rng1(seed_x, lane, dbase + SLOT_EM_SELECT);
      float ue1, ue2;
      rng2(seed_x, lane, dbase + SLOT_EM_POS, ue1, ue2);
      int idx = 0;
      for (int j = 0; j < n_lights; ++j)
        idx += lt[j * LIGHT_COLS + 12] < u_sel ? 1 : 0;
      // a u past the last cdf entry selects no face: all fields zero
      float lr[LIGHT_COLS];
      for (int k = 0; k < LIGHT_COLS; ++k)
        lr[k] = idx < n_lights ? lt[idx * LIGHT_COLS + k] : 0.0f;
      // warp.square_to_uniform_triangle
      const float stri = sqrtf(fmaxf(1.0f - ue1, 0.0f));
      const float b0 = 1.0f - stri;
      const float b1 = stri * ue2;
      const float lpx = lr[0] + lr[3] * b0 + lr[6] * b1;
      const float lpy = lr[1] + lr[4] * b0 + lr[7] * b1;
      const float lpz = lr[2] + lr[5] * b0 + lr[8] * b1;
      float sdx = lpx - px, sdy = lpy - py, sdz = lpz - pz;
      const float sdist2 = fmaxf(sdx * sdx + sdy * sdy + sdz * sdz, 1e-12f);
      const float sdist = sqrtf(sdist2);
      sdx = sdx / sdist;
      sdy = sdy / sdist;
      sdz = sdz / sdist;
      const float cos_l = -(sdx * lr[9] + sdy * lr[10] + sdz * lr[11]);
      const float pdf_nee =
          cos_l > 1e-6f ? lr[13] * sdist2 / fmaxf(cos_l, 1e-6f) : 0.0f;
      const float maxt_s = sdist * (float)(1.0 - 1e-3);
      const float cos_s = sdx * shx + sdy * shy + sdz * shz;
      if (pdf_nee > 0.0f && cos_s > 0.0f) {
        // the shadow ray leaves on the side of the GEOMETRIC normal
        const float sgn_s =
            sdx * ngx + sdy * ngy + sdz * ngz >= 0.0f ? 1.0f : -1.0f;
        const float sox = px + sgn_s * off * ngx;
        const float soy = py + sgn_s * off * ngy;
        const float soz = pz + sgn_s * off * ngz;
        bool occ = false;
        for (int j = 0; j < n_faces && !occ; ++j) {
          float tj;
          occ = tri_test(geo + j * GEO_COLS, sox, soy, soz, sdx, sdy, sdz,
                         maxt_s, tj);
        }
        if (!occ) {
          const float inv_pa = 1.0f / fmaxf(pdf_nee, 1e-20f);
          const float f_pdf = INV_PI * fmaxf(cos_s, 0.0f);
          const float wnee = mis(pdf_nee, f_pdf);
          const float c = INV_PI * cos_s;
          Lr = Lr + Br * (Rr * c * wnee * (lr[14] * inv_pa));
          Lg = Lg + Bg * (Rg * c * wnee * (lr[15] * inv_pa));
          Lb = Lb + Bb * (Rb * c * wnee * (lr[16] * inv_pa));
        }
      }
    }

    // ---- BSDF sampling: cosine hemisphere via the concentric disk
    float ub1, ub2;
    rng2(seed_x, lane, dbase + SLOT_BSDF_DIR, ub1, ub2);
    const float x = 2.0f * ub1 - 1.0f;
    const float y = 2.0f * ub2 - 1.0f;
    const bool quad_x = fabsf(x) > fabsf(y);
    const float ratio = quad_x ? y / (x != 0.0f ? x : 1.0f)
                               : x / (y != 0.0f ? y : 1.0f);
    const float phi = quad_x ? PI_4 * ratio : PI_2 - PI_4 * ratio;
    const float r = (x == 0.0f && y == 0.0f) ? 0.0f : (quad_x ? x : y);
    const float dxl = r * cosf(phi);
    const float dyl = r * sinf(phi);
    const float dzl = sqrtf(fmaxf(1.0f - (dxl * dxl + dyl * dyl), 0.0f));
    const float ndx = sx * dxl + tx * dyl + shx * dzl;
    const float ndy = sy * dxl + ty * dyl + shy * dzl;
    const float ndz = sz * dxl + tz * dyl + shz * dzl;
    const float pdf_fwd = INV_PI * dzl;
    Br = Br * Rr;
    Bg = Bg * Rg;
    Bb = Bb * Rb;
    const float bmax = fmaxf(Br, fmaxf(Bg, Bb));
    if (!(pdf_fwd > 0.0f && bmax > 0.0f)) break;
    const float sgn_b = ndx * ngx + ndy * ngy + ndz * ngz >= 0.0f ? 1.0f : -1.0f;
    ox = px + sgn_b * off * ngx;
    oy = py + sgn_b * off * ngy;
    oz = pz + sgn_b * off * ngz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    prev_pdf = pdf_fwd;
    prev_delta = false;

    // ---- russian roulette (path.py:117-128); eta_acc is 1 for diffuse
    if (depth + 1 >= rr_depth) {
      const float rr_p = fminf(bmax, 0.95f);
      const float u_rr = rng1(seed_x, lane, dbase + SLOT_RR);
      const float inv_p = 1.0f / fmaxf(rr_p, 1e-8f);
      Br = Br * inv_p;
      Bg = Bg * inv_p;
      Bb = Bb * inv_p;
      act = u_rr < rr_p;
    }
  }
  out[3 * i] = Lr;
  out[3 * i + 1] = Lg;
  out[3 * i + 2] = Lb;
}

}  // namespace

// Launches the kernel on `stream` over n lanes; allocates nothing and
// does not synchronise.  Returns cudaGetLastError() of the launch.
extern "C" int megakernel_trace(const float* tris, int n_faces,
                                const float* light, int n_lights,
                                const int32_t* lanes, const float* o,
                                const float* d, const uint8_t* active,
                                uint32_t seed, int max_depth, int rr_depth,
                                int n, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem =
      (size_t)(n_faces * GEO_COLS + n_lights * LIGHT_COLS) * sizeof(float);
  megakernel_trace_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tris, n_faces, light, n_lights, lanes, o, d, active, seed, max_depth,
      rr_depth, n, out);
  return (int)cudaGetLastError();
}
