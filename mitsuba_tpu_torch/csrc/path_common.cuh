// Device code shared by the port's path-tracing kernels (sm_90a):
// csrc/megakernel.cu (brute force over shared memory) and
// csrc/megakernel_bvh.cu (two-child-box BVH walk over global memory).
//
// ONE bounce body, `bounce`, templated on the hit query, is the
// counterpart of _bounce_step in mitsuba_tpu/ops/pallas/megakernel.py
// (:882) for BSDF codes 0-4: closest hit -> emitter-hit MIS ->
// area-light NEE with a shadow ray -> BSDF sampling -> russian roulette.
// All three kernels run it, so they cannot drift apart; `trace_paths`
// loops it over a frame for the two whole-path kernels.  A query provides
//   int  closest(ox, oy, oz, dx, dy, dz, float& t)   face id or -1
//   bool occluded(ox, oy, oz, dx, dy, dz, maxt)
//
// The lobe set is a template parameter, as the TPU kernel specialises on
// its static btypes.  LOBES = false is the constant-diffuse body (btypes
// == (0,)): cosine sampling, no lobe draw, eta_acc stays 1.  LOBES = true
// adds, per the face row's type code (column 17), the smooth conductor
// (1), smooth dielectric (2), GGX rough conductor (3) and GGX rough
// dielectric (4): a mirror or Fresnel-chosen reflection or refraction,
// VNDF sampling, the GGX lobes' NEE evaluation, two-sided dielectrics,
// and eta_acc^2 in russian roulette.  A code outside 0-4 ends the path
// after its emitter term.  One departure from the TPU kernel, as the
// wavefront path: a sampled rough-dielectric lobe is not Dirac (the TPU
// kernel's smooth_lobe, megakernel.py:1539, leaves it out, so it adds
// the light reached after it twice; ops/megakernel.py).
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
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);

// models/integrators/common.py dimension layout
constexpr uint32_t DIM_BOUNCE_BASE = 8;
constexpr uint32_t DIMS_PER_BOUNCE = 8;
constexpr uint32_t SLOT_EM_SELECT = 0;
constexpr uint32_t SLOT_EM_POS = 1;
constexpr uint32_t SLOT_BSDF_LOBE = 2;
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

// ------------------------------------------------------------- the lobes
// Componentwise mirrors of the TPU kernel's helpers (megakernel.py :626
// _safe_sqrt_t ... :790 _vndf_sample), in their order of operations.
// BSDF type codes of the face table's column 17 (ops/megakernel.py).
constexpr int CONDUCTOR = 1, DIELECTRIC = 2, ROUGH_CONDUCTOR = 3,
              ROUGH_DIELECTRIC = 4;

__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(fmaxf(x, 0.0f));
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 1e-20f ? a / b : 0.0f;
}

__device__ __forceinline__ float rsqrt_safe(float x) {
  return x > 1e-20f ? 1.0f / sqrtf(fmaxf(x, 1e-20f)) : 0.0f;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Smith masking of GGX (_ggx_g1 :649)
__device__ __forceinline__ float ggx_g1(float wx, float wy, float wz,
                                        float mx, float my, float mz,
                                        float a) {
  const float c2 = wz * wz;
  const float a2 = (wx * a) * (wx * a) + (wy * a) * (wy * a);
  const float lam = 0.5f * (safe_sqrt(1.0f + safe_div(a2, c2)) - 1.0f);
  const float g = 1.0f / (1.0f + lam);
  return ((wx * mx + wy * my + wz * mz) * wz) <= 0.0f ? 0.0f : g;
}

// GGX normal distribution (_ggx_d :658)
__device__ __forceinline__ float ggx_d(float mx, float my, float mz,
                                       float a) {
  const float t = (mx / a) * (mx / a) + (my / a) * (my / a) + mz * mz;
  const float d = safe_div(1.0f, PI_F * a * a * (t * t));
  return mz > 0.0f ? d : 0.0f;
}

// pdf of vndf_sample in the half-vector measure (_vndf_pdf :664)
__device__ __forceinline__ float vndf_pdf(float wix, float wiy, float wiz,
                                          float mx, float my, float mz,
                                          float a) {
  const float g1 = ggx_g1(wix, wiy, wiz, mx, my, mz, a);
  return safe_div(
      g1 * fabsf(wix * mx + wiy * my + wiz * mz) * ggx_d(mx, my, mz, a),
      fabsf(wiz));
}

// Conductor Fresnel, one channel (_fr_cond :672)
__device__ __forceinline__ float fr_cond(float c, float e, float k) {
  const float c2 = c * c;
  const float s2 = 1.0f - c2;
  const float e2 = e * e;
  const float k2 = k * k;
  const float t0 = e2 - k2 - s2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  const float t1 = a2b2 + c2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * fabsf(c);
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-20f);
  const float t3 = c2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-20f);
  return 0.5f * (rp + rs);
}

// Dielectric Fresnel of a signed cosine (_fr_diel :740): F, the signed
// cosine of the transmitted ray (0 on total internal reflection), eta_it
// and eta_ti.
__device__ __forceinline__ float fr_diel(float ci, float eta, float& cos_t,
                                         float& eta_it, float& eta_ti) {
  const bool outside = ci >= 0.0f;
  eta_it = outside ? eta : 1.0f / eta;
  eta_ti = outside ? 1.0f / eta : eta;
  const float cti = fabsf(ci);
  const float sin2_t = (eta_ti * eta_ti) * fmaxf(0.0f, 1.0f - cti * cti);
  const bool tir = sin2_t >= 1.0f;
  const float ctt = safe_sqrt(1.0f - sin2_t);
  const float rs = (cti - eta_it * ctt) / fmaxf(cti + eta_it * ctt, 1e-20f);
  const float rp = (eta_it * cti - ctt) / fmaxf(eta_it * cti + ctt, 1e-20f);
  float f = 0.5f * (rs * rs + rp * rp);
  f = tir ? 1.0f : f;
  f = fabsf(eta - 1.0f) < 1e-6f ? 0.0f : f;
  cos_t = tir ? 0.0f : -sign_of(ci) * ctt;
  return f;
}

// Heitz 2018 visible-normal sample, isotropic (_vndf_sample :760)
__device__ __forceinline__ void vndf_sample(float wix, float wiy, float wiz,
                                            float u1, float u2, float a,
                                            float& mx, float& my,
                                            float& mz) {
  const float hx = a * wix, hy = a * wiy, hz = wiz;
  const float inv = rsqrt_safe(hx * hx + hy * hy + hz * hz);
  const float vhx = hx * inv, vhy = hy * inv, vhz = hz * inv;
  const float lensq = vhx * vhx + vhy * vhy;
  const float inv2 = safe_div(1.0f, safe_sqrt(lensq));
  const bool ok = lensq > 1e-12f;
  const float t1x = ok ? -vhy * inv2 : 1.0f;
  const float t1y = ok ? vhx * inv2 : 0.0f;
  const float t1z = 0.0f;
  const float t2x = vhy * t1z - vhz * t1y;
  const float t2y = vhz * t1x - vhx * t1z;
  const float t2z = vhx * t1y - vhy * t1x;
  const float r = safe_sqrt(u1);
  const float phi = TWO_PI * u2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float sh = 0.5f * (1.0f + vhz);
  p2 = (1.0f - sh) * safe_sqrt(1.0f - p1 * p1) + sh * p2;
  const float p3 = safe_sqrt(fmaxf(0.0f, 1.0f - p1 * p1 - p2 * p2));
  const float nhx = p1 * t1x + p2 * t2x + p3 * vhx;
  const float nhy = p1 * t1y + p2 * t2y + p3 * vhy;
  const float nhz = p1 * t1z + p2 * t2z + p3 * vhz;
  const float ex = a * nhx, ey = a * nhy, ez = fmaxf(1e-6f, nhz);
  const float inv3 = rsqrt_safe(ex * ex + ey * ey + ez * ez);
  mx = ex * inv3;
  my = ey * inv3;
  mz = ez * inv3;
}

// f x |cos| (the same in each channel) and pdf of the rough dielectric
// toward the local direction wo, either side (RoughDielectric.eval_pdf;
// the TPU kernel's NEE :1172).
__device__ __forceinline__ float rough_dielectric_eval(
    float wix, float wiy, float wiz, float wox, float woy, float woz,
    float a, float eta_d, float& pdf) {
  const bool refl = wiz * woz > 0.0f;
  const float eta_path = wiz > 0.0f ? eta_d : 1.0f / eta_d;
  float qx = refl ? wix + wox : wix + wox * eta_path;
  float qy = refl ? wiy + woy : wiy + woy * eta_path;
  float qz = refl ? wiz + woz : wiz + woz * eta_path;
  const float n2 = qx * qx + qy * qy + qz * qz;
  const float qinv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  qx = qx * qinv;
  qy = qy * qinv;
  qz = qz * qinv;
  const float sg_m = qz >= 0.0f ? 1.0f : -1.0f;
  qx = qx * sg_m;
  qy = qy * sg_m;
  qz = qz * sg_m;
  const float sgn_i = wiz >= 0.0f ? 1.0f : -1.0f;
  const float mox = qx * sgn_i, moy = qy * sgn_i, moz = qz * sgn_i;
  const float cim = wix * mox + wiy * moy + wiz * moz;
  const float com = wox * mox + woy * moy + woz * moz;
  float cos_t, eta_it, eta_ti;
  const float fD = fr_diel(cim, eta_d, cos_t, eta_it, eta_ti);
  const float sgn_o = woz >= 0.0f ? 1.0f : -1.0f;
  const float d_g = ggx_d(qx, qy, qz, a);
  const float g2 =
      ggx_g1(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, qx, qy, qz, a) *
      ggx_g1(wox * sgn_o, woy * sgn_o, woz * sgn_o, qx, qy, qz, a);
  const float den = cim + eta_it * com;
  float val;
  if (refl) {
    val = fD * d_g * g2 / fmaxf(4.0f * fabsf(wiz), 1e-20f);
  } else {
    val = fabsf(((1.0f - fD) * d_g * g2 * fabsf(cim * com) *
                 (eta_it * eta_it) / fmaxf(fabsf(wiz) * den * den, 1e-20f)) *
                (eta_ti * eta_ti));
  }
  const float pdm =
      vndf_pdf(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, qx, qy, qz, a);
  pdf = refl ? pdm * (fD * (1.0f / fmaxf(4.0f * fabsf(com), 1e-20f)))
             : pdm * ((1.0f - fD) * (fabsf(com) * (eta_it * eta_it) /
                                     fmaxf(den * den, 1e-20f)));
  const bool ok = fabsf(wiz) > 1e-6f && n2 > 1e-20f &&
                  (refl || cim * com < 0.0f);
  if (!ok) {
    pdf = 0.0f;
    return 0.0f;
  }
  return val;
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

// Cosine-hemisphere direction via the concentric disk (warp.py
// square_to_cosine_hemisphere).
__device__ __forceinline__ void cosine_hemisphere(float ub1, float ub2,
                                                  float& dxl, float& dyl,
                                                  float& dzl) {
  const float x = 2.0f * ub1 - 1.0f;
  const float y = 2.0f * ub2 - 1.0f;
  const bool quad_x = fabsf(x) > fabsf(y);
  const float ratio = quad_x ? y / (x != 0.0f ? x : 1.0f)
                             : x / (y != 0.0f ? y : 1.0f);
  const float phi = quad_x ? PI_4 * ratio : PI_2 - PI_4 * ratio;
  const float r = (x == 0.0f && y == 0.0f) ? 0.0f : (quad_x ? x : y);
  dxl = r * cosf(phi);
  dyl = r * sinf(phi);
  dzl = sqrtf(fmaxf(1.0f - (dxl * dxl + dyl * dyl), 0.0f));
}

// The lobe bounce's BSDF sampling, spawn and russian roulette (the TPU
// kernel's :1261-:1560) for a lane whose path goes on at a face of type
// `code` (0-4); the frame (s, t, sh) and, on a GGX face, the local wi
// and alpha are the bounce's.
__device__ __forceinline__ void sample_lobe(
    int code, uint32_t seed_x, uint32_t lane, uint32_t dbase, float dx,
    float dy, float dz, float cos_wi, float shx, float shy, float shz,
    float sx, float sy, float sz, float tx, float ty, float tz, float wix,
    float wiy, float wiz, float alpha, const float* row, float px, float py,
    float pz, float off, float ngx, float ngy, float ngz, int depth,
    int rr_depth, PathState& s) {
  float ub1, ub2;
  rng2(seed_x, lane, dbase + SLOT_BSDF_DIR, ub1, ub2);
  const float u_lobe = rng1(seed_x, lane, dbase + SLOT_BSDF_LOBE);
  float lx, ly, lz;             // a local direction (diffuse, GGX)
  float ndx, ndy, ndz;          // the world direction
  float wR, wG, wB, pdf_fwd;    // weight and pdf of the sample
  float eta_mult = 1.0f;
  bool local = true, delta = false;
  if (code == 0) {  // SmoothDiffuse.sample
    cosine_hemisphere(ub1, ub2, lx, ly, lz);
    wR = row[9];
    wG = row[10];
    wB = row[11];
    pdf_fwd = INV_PI * lz;
  } else if (code == CONDUCTOR || code == DIELECTRIC) {
    local = false;
    delta = true;
    // the mirror direction, world form
    const float rx = dx + 2.0f * cos_wi * shx;
    const float ry = dy + 2.0f * cos_wi * shy;
    const float rz = dz + 2.0f * cos_wi * shz;
    if (code == CONDUCTOR) {  // SmoothConductor.sample (:1285)
      ndx = rx;
      ndy = ry;
      ndz = rz;
      wR = fr_cond(cos_wi, row[18], row[21]);
      wG = fr_cond(cos_wi, row[19], row[22]);
      wB = fr_cond(cos_wi, row[20], row[23]);
      pdf_fwd = 1.0f;
    } else {  // SmoothDielectric.sample: reflect or refract by Fresnel
      float cos_t, eta_it, eta_ti;
      const float Fd =
          fr_diel(cos_wi, fmaxf(row[18], 1e-3f), cos_t, eta_it, eta_ti);
      const bool pick_r = u_lobe <= Fd;
      const float tfac = eta_ti * cos_wi + cos_t;
      ndx = pick_r ? rx : eta_ti * dx + tfac * shx;
      ndy = pick_r ? ry : eta_ti * dy + tfac * shy;
      ndz = pick_r ? rz : eta_ti * dz + tfac * shz;
      wR = wG = wB = pick_r ? 1.0f : eta_ti * eta_ti;
      pdf_fwd = pick_r ? Fd : 1.0f - Fd;
      eta_mult = pick_r ? 1.0f : eta_it;
    }
  } else if (code == ROUGH_CONDUCTOR) {  // RoughConductor.sample (:1323)
    float mx, my, mz;
    vndf_sample(wix, wiy, wiz, ub1, ub2, alpha, mx, my, mz);
    const float cim = wix * mx + wiy * my + wiz * mz;
    lx = 2.0f * cim * mx - wix;
    ly = 2.0f * cim * my - wiy;
    lz = 2.0f * cim * mz - wiz;
    const float pdf_m = vndf_pdf(wix, wiy, wiz, mx, my, mz, alpha);
    const float com = lx * mx + ly * my + lz * mz;
    const float g1w = ggx_g1(wix, wiy, wiz, mx, my, mz, alpha);
    const float g1o = ggx_g1(lx, ly, lz, mx, my, mz, alpha);
    const float wgt = g1w > 0.0f ? g1w * g1o / fmaxf(g1w, 1e-20f) : 0.0f;
    wR = fr_cond(cim, row[18], row[21]) * wgt;
    wG = fr_cond(cim, row[19], row[22]) * wgt;
    wB = fr_cond(cim, row[20], row[23]) * wgt;
    pdf_fwd = wiz > 0.0f && lz > 0.0f
                  ? pdf_m / fmaxf(4.0f * fabsf(com), 1e-20f)
                  : 0.0f;
  } else {  // RoughDielectric.sample (:1355)
    const float eta_d = fmaxf(row[18], 1e-3f);
    const float sgn_i = wiz >= 0.0f ? 1.0f : -1.0f;
    float mx, my, mz;
    vndf_sample(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, ub1, ub2, alpha, mx,
                my, mz);
    const float mox = mx * sgn_i, moy = my * sgn_i, moz = mz * sgn_i;
    const float cim = wix * mox + wiy * moy + wiz * moz;
    float cos_t, eta_it, eta_ti;
    const float fD = fr_diel(cim, eta_d, cos_t, eta_it, eta_ti);
    const bool pick = u_lobe <= fD;
    const float tfac = cim * eta_ti + cos_t;
    lx = pick ? 2.0f * cim * mox - wix : mox * tfac - wix * eta_ti;
    ly = pick ? 2.0f * cim * moy - wiy : moy * tfac - wiy * eta_ti;
    lz = pick ? 2.0f * cim * moz - wiz : moz * tfac - wiz * eta_ti;
    const float g1i =
        ggx_g1(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, mx, my, mz, alpha);
    const float sgn_o = lz >= 0.0f ? 1.0f : -1.0f;
    const float g2 =
        g1i * ggx_g1(lx * sgn_o, ly * sgn_o, lz * sgn_o, mx, my, mz, alpha);
    float w = g1i > 0.0f ? g2 / fmaxf(g1i, 1e-20f) : 0.0f;
    w = pick ? w : w * (eta_ti * eta_ti);
    wR = wG = wB = w;
    const float pdm =
        vndf_pdf(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, mx, my, mz, alpha);
    const float com = lx * mox + ly * moy + lz * moz;
    const float den = cim + eta_it * com;
    pdf_fwd = pick ? pdm * (fD * (1.0f / fmaxf(4.0f * fabsf(com), 1e-20f)))
                   : pdm * ((1.0f - fD) * (fabsf(com) * (eta_it * eta_it) /
                                           fmaxf(den * den, 1e-20f)));
    const bool same = lz * wiz > 0.0f;
    if (!(pick ? same : !same && cos_t != 0.0f)) pdf_fwd = 0.0f;
    eta_mult = pick ? 1.0f : eta_it;
  }
  if (local) {
    ndx = sx * lx + tx * ly + shx * lz;
    ndy = sy * lx + ty * ly + shy * lz;
    ndz = sz * lx + tz * ly + shz * lz;
  }
  s.Br = s.Br * wR;
  s.Bg = s.Bg * wG;
  s.Bb = s.Bb * wB;
  s.eta = s.eta * eta_mult;
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
  s.prev_delta = delta;

  // ---- russian roulette (path.py:117-128), with the eta^2 factor
  if (depth + 1 >= rr_depth) {
    const float rr_p = fminf(bmax * s.eta * s.eta, 0.95f);
    const float u_rr = rng1(seed_x, lane, dbase + SLOT_RR);
    const float inv_p = 1.0f / fmaxf(rr_p, 1e-8f);
    s.Br = s.Br * inv_p;
    s.Bg = s.Bg * inv_p;
    s.Bb = s.Bb * inv_p;
    s.act = u_rr < rr_p;
  }
}

// One bounce of an active lane at `depth`.  On return s.act says whether
// the path goes on; when it is false only L is meaningful.  `tris` is
// pack_scene's face table in face order; `lt` the light table.  LOBES:
// the lobe set (the file's head).
template <bool LOBES, class Query>
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
  // the face's lobe; the dielectrics are two-sided
  const int code = LOBES ? (int)rintf(row[17]) : 0;
  const bool two_sided = code == DIELECTRIC || code == ROUGH_DIELECTRIC;
  if (!(front || two_sided) || depth + 1 >= max_depth ||
      (unsigned)code > (unsigned)ROUGH_DIELECTRIC) {
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
  // the GGX lobes' local wi and alpha (column 16 on a rough face)
  const bool ggx = code == ROUGH_CONDUCTOR || code == ROUGH_DIELECTRIC;
  float wix = 0.0f, wiy = 0.0f, alpha = 0.0f;
  if (ggx) {
    wix = -(dx * sx + dy * sy + dz * sz);
    wiy = -(dx * tx + dy * ty + dz * tz);
    alpha = fmaxf(PdfA, 1e-4f);
  }
  const float wiz = cos_wi;

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
    if constexpr (LOBES) {
      // the lobe's f x cos and pdf toward the light; the Dirac lobes
      // evaluate to 0 and trace no shadow ray
      float fr = 0.0f, fg = 0.0f, fb = 0.0f, f_pdf = 0.0f;
      bool ok = false;
      if (code == 0) {
        ok = front && cos_s > 0.0f;
        const float c = INV_PI * cos_s;
        fr = Rr * c;
        fg = Rg * c;
        fb = Rb * c;
        f_pdf = INV_PI * fmaxf(cos_s, 0.0f);
      } else if (ggx) {
        const float wox = sdx * sx + sdy * sy + sdz * sz;
        const float woy = sdx * tx + sdy * ty + sdz * tz;
        const float woz = cos_s;
        if (code == ROUGH_CONDUCTOR) {  // RoughConductor.eval (:1139)
          ok = front && cos_s > 0.0f;
          float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
          const float hn = sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
          hx = hx / hn;
          hy = hy / hn;
          hz = hz / hn;
          const float g2 = ggx_g1(wix, wiy, wiz, hx, hy, hz, alpha) *
                           ggx_g1(wox, woy, woz, hx, hy, hz, alpha);
          const float cos_im = wix * hx + wiy * hy + wiz * hz;
          const float scal =
              ggx_d(hx, hy, hz, alpha) * g2 / fmaxf(4.0f * wiz, 1e-20f);
          fr = fr_cond(cos_im, row[18], row[21]) * scal;
          fg = fr_cond(cos_im, row[19], row[22]) * scal;
          fb = fr_cond(cos_im, row[20], row[23]) * scal;
          f_pdf = vndf_pdf(wix, wiy, wiz, hx, hy, hz, alpha) /
                  fmaxf(4.0f * fabsf(wox * hx + woy * hy + woz * hz), 1e-20f);
        } else {  // RoughDielectric.eval_pdf, either side (:1172)
          fr = fg = fb = rough_dielectric_eval(wix, wiy, wiz, wox, woy, woz,
                                               alpha, fmaxf(row[18], 1e-3f),
                                               f_pdf);
          ok = fr > 0.0f;
        }
      }
      if (ok && pdf_nee > 0.0f) {
        const float sgn_s =
            sdx * ngx + sdy * ngy + sdz * ngz >= 0.0f ? 1.0f : -1.0f;
        const float sox = px + sgn_s * off * ngx;
        const float soy = py + sgn_s * off * ngy;
        const float soz = pz + sgn_s * off * ngz;
        if (!q.occluded(sox, soy, soz, sdx, sdy, sdz, maxt_s)) {
          const float inv_pa = 1.0f / fmaxf(pdf_nee, 1e-20f);
          const float wnee = mis(pdf_nee, f_pdf);
          s.Lr = s.Lr + s.Br * (fr * wnee * (lr[14] * inv_pa));
          s.Lg = s.Lg + s.Bg * (fg * wnee * (lr[15] * inv_pa));
          s.Lb = s.Lb + s.Bb * (fb * wnee * (lr[16] * inv_pa));
        }
      }
    } else if (pdf_nee > 0.0f && cos_s > 0.0f) {
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

  if constexpr (LOBES) {
    sample_lobe(code, seed_x, lane, dbase, dx, dy, dz, cos_wi, shx, shy, shz,
                sx, sy, sz, tx, ty, tz, wix, wiy, wiz, alpha, row, px, py, pz,
                off, ngx, ngy, ngz, depth, rr_depth, s);
    return;
  }

  // ---- BSDF sampling: cosine hemisphere via the concentric disk
  float ub1, ub2;
  rng2(seed_x, lane, dbase + SLOT_BSDF_DIR, ub1, ub2);
  float dxl, dyl, dzl;
  cosine_hemisphere(ub1, ub2, dxl, dyl, dzl);
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

  // ---- russian roulette (path.py:117-128); the diffuse-only body keeps
  // eta_acc at 1
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
template <bool LOBES, class Query>
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
      bounce<LOBES>(q, tris, lt, n_lights, smooth, seed_x, lane_id, depth,
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
