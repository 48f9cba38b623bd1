// Device code shared by the port's path-tracing kernels (sm_90a):
// csrc/megakernel.cu (brute force over shared memory) and
// csrc/megakernel_bvh.cu (two-child-box BVH walk over global memory).
//
// ONE bounce body, `bounce`, templated on the hit query, is the
// counterpart of _bounce_step in mitsuba_tpu/ops/pallas/megakernel.py
// (:833) for the constant-diffuse specialisation: closest hit ->
// emitter-hit MIS -> area-light NEE with a shadow ray -> cosine BSDF
// sampling -> russian roulette.  All three kernels run it, so they
// cannot drift apart; `trace_paths` loops it over a frame for the two
// whole-path kernels.  A query provides
//   int  closest(ox, oy, oz, dx, dy, dz, float& t)   face id or -1
//   bool occluded(ox, oy, oz, dx, dy, dz, maxt)
//
// Numerics follow the JAX kernel operation for operation.  Build with
// -fmad=false and without fast math: sqrtf, 1.0f / sqrtf(x) for rsqrt,
// IEEE division, sinf/cosf.  The RNG (PCG3D over seed, lane, dim) is
// bit-exact with mitsuba_tpu/core/rng.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mk {

constexpr int TRI_COLS = 39;
constexpr int LIGHT_COLS = 17;
constexpr int MAX_LIGHT_FACES = 16;
constexpr int STATE_COLS = 16;

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
// Moller-Trumbore against one face g = [p0 | e1 | e2] (ops/intersect.py
// tri_test_uv); true iff hit with 0 < t <= maxt.  With UV, also stores
// the barycentrics of the hit in *u_out and *v_out (csrc/intersect_packed.cu);
// without UV those stores compile away.
template <bool UV = false>
__device__ __forceinline__ bool tri_test(const float* g, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float maxt, float& t,
                                         float* u_out = nullptr,
                                         float* v_out = nullptr) {
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
  if constexpr (UV) {
    *u_out = u;
    *v_out = vv;
  }
  return ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > 0.0f &&
         t <= maxt;
}

__device__ __forceinline__ float mis(float pa, float pb) {
  const float a2 = pa * pa;
  const float w = a2 / fmaxf(a2 + pb * pb, 1e-32f);
  return pa > 0.0f ? w : 0.0f;
}

// The 16-float per-lane state of megakernel_bounce_bvh, in its order:
// o(3), d(3), L(3), throughput(3), eta_acc, prev_pdf, prev_delta, act.
struct PathState {
  float ox, oy, oz, dx, dy, dz;
  float Lr, Lg, Lb, Br, Bg, Bb;
  float eta, prev_pdf;
  bool prev_delta, act;
};

// Stage the light table into shared memory `lt` (whole block).
__device__ __forceinline__ void stage_light(float* lt,
                                            const float* __restrict__ light,
                                            int n_lights) {
  for (int k = threadIdx.x; k < n_lights * LIGHT_COLS; k += blockDim.x)
    lt[k] = light[k];
}

// One bounce of an active lane at `depth`.  On return s.act says whether
// the path goes on; when it is false only L is meaningful.  `tris` is
// pack_scene's face table in face order; `lt` the light table.
template <class Query>
__device__ __forceinline__ void bounce(const Query& q,
                                       const float* __restrict__ tris,
                                       const float* lt, int n_lights,
                                       bool smooth, uint32_t seed_x,
                                       uint32_t lane, int depth,
                                       int max_depth, int rr_depth,
                                       PathState& s) {
  const uint32_t dbase = DIM_BOUNCE_BASE + (uint32_t)depth * DIMS_PER_BOUNCE;
  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;

  // ---- closest hit; the winner's attributes are read once after it
  float t;
  const int best = q.closest(ox, oy, oz, dx, dy, dz, t);
  if (best < 0) {  // miss: nothing more reaches this lane
    s.act = false;
    return;
  }
  const float* row = tris + (size_t)best * TRI_COLS;
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
  float shx = ngx, shy = ngy, shz = ngz;
  if (smooth) {
    // the winner's barycentrics, clipped (compute_si mirror), and the
    // interpolated shading normal; flat faces store ng at all 3 slots
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv = fabsf(det) > DET_EPS ? 1.0f / det : 0.0f;
    const float tvx = ox - row[0], tvy = oy - row[1], tvz = oz - row[2];
    const float ub =
        fminf(fmaxf((tvx * pvx + tvy * pvy + tvz * pvz) * inv, 0.0f), 1.0f);
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float vb =
        fminf(fmaxf((dx * qvx + dy * qvy + dz * qvz) * inv, 0.0f), 1.0f);
    const float b0 = 1.0f - ub - vb;
    const float nsx = row[30] * b0 + row[33] * ub + row[36] * vb;
    const float nsy = row[31] * b0 + row[34] * ub + row[37] * vb;
    const float nsz = row[32] * b0 + row[35] * ub + row[38] * vb;
    const float n2 = nsx * nsx + nsy * nsy + nsz * nsz;
    const float rinv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
    shx = nsx * rinv;
    shy = nsy * rinv;
    shz = nsz * rinv;
  }

  const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
  const float cos_wi = -(dx * shx + dy * shy + dz * shz);
  const float cos_geo = -(dx * ngx + dy * ngy + dz * ngz);
  const bool front = cos_wi > 0.0f;

  // ---- MIS'd radiance of a directly hit emitter (path.py:82); the
  // face table's emission column is exactly is_light * Le
  if (front && IsL > 0.5f) {
    const float dist2 = t * t;
    const float pdf_hit =
        cos_geo > 1e-6f ? PdfA * dist2 / fmaxf(cos_geo, 1e-6f) : 0.0f;
    const float m_h = s.prev_delta ? 1.0f : mis(s.prev_pdf, pdf_hit);
    const float Ler0 = n_lights > 0 ? lt[14] : 0.0f;
    const float Leg0 = n_lights > 0 ? lt[15] : 0.0f;
    const float Leb0 = n_lights > 0 ? lt[16] : 0.0f;
    s.Lr = s.Lr + s.Br * (IsL * Ler0) * m_h;
    s.Lg = s.Lg + s.Bg * (IsL * Leg0) * m_h;
    s.Lb = s.Lb + s.Bb * (IsL * Leb0) * m_h;
  }
  if (!front || depth + 1 >= max_depth) {
    s.act = false;
    return;
  }

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
      if (!q.occluded(sox, soy, soz, sdx, sdy, sdz, maxt_s)) {
        const float inv_pa = 1.0f / fmaxf(pdf_nee, 1e-20f);
        const float f_pdf = INV_PI * fmaxf(cos_s, 0.0f);
        const float wnee = mis(pdf_nee, f_pdf);
        const float c = INV_PI * cos_s;
        s.Lr = s.Lr + s.Br * (Rr * c * wnee * (lr[14] * inv_pa));
        s.Lg = s.Lg + s.Bg * (Rg * c * wnee * (lr[15] * inv_pa));
        s.Lb = s.Lb + s.Bb * (Rb * c * wnee * (lr[16] * inv_pa));
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
  s.Br = s.Br * Rr;
  s.Bg = s.Bg * Rg;
  s.Bb = s.Bb * Rb;
  const float bmax = fmaxf(s.Br, fmaxf(s.Bg, s.Bb));
  if (!(pdf_fwd > 0.0f && bmax > 0.0f)) {
    s.act = false;
    return;
  }
  const float sgn_b = ndx * ngx + ndy * ngy + ndz * ngz >= 0.0f ? 1.0f : -1.0f;
  s.ox = px + sgn_b * off * ngx;
  s.oy = py + sgn_b * off * ngy;
  s.oz = pz + sgn_b * off * ngz;
  s.dx = ndx;
  s.dy = ndy;
  s.dz = ndz;
  s.prev_pdf = pdf_fwd;
  s.prev_delta = false;

  // ---- russian roulette (path.py:117-128); eta_acc is 1 for diffuse
  if (depth + 1 >= rr_depth) {
    const float rr_p = fminf(bmax, 0.95f);
    const float u_rr = rng1(seed_x, lane, dbase + SLOT_RR);
    const float inv_p = 1.0f / fmaxf(rr_p, 1e-8f);
    s.Br = s.Br * inv_p;
    s.Bg = s.Bg * inv_p;
    s.Bb = s.Bb * inv_p;
    s.act = u_rr < rr_p;
  }
}

__device__ __forceinline__ PathState primary_state(
    const float* __restrict__ o, const float* __restrict__ d,
    const uint8_t* __restrict__ active, int i) {
  PathState s;
  s.ox = o[3 * i];
  s.oy = o[3 * i + 1];
  s.oz = o[3 * i + 2];
  s.dx = d[3 * i];
  s.dy = d[3 * i + 1];
  s.dz = d[3 * i + 2];
  s.Lr = s.Lg = s.Lb = 0.0f;
  s.Br = s.Bg = s.Bb = 1.0f;
  s.eta = 1.0f;
  s.prev_pdf = 1.0f;
  s.prev_delta = true;
  s.act = active[i] != 0;
  return s;
}

constexpr unsigned FULL_MASK = 0xffffffffu;

// The whole frame's paths in a persistent grid, with path regeneration:
// the body of both whole-path kernels (csrc/megakernel.cu over every face,
// csrc/megakernel_bvh.cu over the BVH).  Each thread holds one path at a
// time: its slot, its depth and its PathState, in registers.  At each
// step every thread that holds a path runs one `bounce` at its own depth;
// when a path ends (miss, back face, russian roulette, max_depth, or an
// input slot that is not active) the thread writes its radiance to
// out[3 * slot ..], and the finished lanes of the warp take the next
// unstarted slots with one atomicAdd on `next_slot` (the ballot of the
// finished lanes gives the count, each lane's rank in it the offset).  So
// warps stay full until the frame's slots run out, instead of idling until
// their longest path ends.  A warp leaves when no lane holds a path and
// the counter has passed n.  Every random number is a pure function of
// (seed, lane id, dim), so a slot's radiance does not depend on which
// thread traces it, or when.  All threads of the block must call it.
template <class Query>
__device__ __forceinline__ void trace_paths(
    const Query& q, const float* __restrict__ tris, const float* lt,
    int n_lights, bool smooth, uint32_t seed, const int32_t* __restrict__ lanes,
    const float* __restrict__ o, const float* __restrict__ d,
    const uint8_t* __restrict__ active, int max_depth, int rr_depth, int n,
    float* __restrict__ out, unsigned* __restrict__ next_slot) {
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
      bounce(q, tris, lt, n_lights, smooth, seed_x, lane_id, depth,
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

}  // namespace mk
