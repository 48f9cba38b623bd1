// Device code shared by the port's path-tracing kernels (sm_90a):
// csrc/megakernel.cu (brute force over shared memory) and
// csrc/megakernel_bvh.cu (two-child-box BVH walk over global memory).
//
// ONE bounce body, `bounce`, templated on the hit query, is the
// counterpart of _bounce_step in mitsuba_tpu/ops/pallas/megakernel.py
// (:882) for BSDF codes 0-7 and 16-23: closest hit (or, for an escaped
// ray, the environment map's radiance) -> texture fetch -> emitter-hit MIS
// -> NEE toward the area light or the environment map with a shadow ray
// -> BSDF sampling -> russian roulette.
// All three kernels run it, so they cannot drift apart; `trace_paths`
// loops it over a frame for the two whole-path kernels.  A query provides
//   int  closest(ox, oy, oz, dx, dy, dz, float& t)   face id or -1
//   bool occluded(ox, oy, oz, dx, dy, dz, maxt)
//
// The lobe set is a template parameter, as the TPU kernel specialises on
// its static btypes (ops/megakernel.py lobes_flag picks the build):
// - DIFFUSE_BUILD is the constant-diffuse body (btypes == (0,)): cosine
//   sampling, no lobe draw, eta_acc stays 1;
// - LOBE_BUILD adds, per the face row's type code (column 17), the smooth
//   conductor (1), smooth dielectric (2), GGX rough conductor (3) and GGX
//   rough dielectric (4): a mirror or Fresnel-chosen reflection or
//   refraction, VNDF sampling, the GGX lobes' NEE evaluation, two-sided
//   dielectrics, and eta_acc^2 in russian roulette;
// - SURFACE_BUILD adds the bitmap-textured diffuse (5: after the closest
//   hit its reflectance is read from the texture arena at the hit's uv,
//   and it goes on as code 0), the smooth plastic (6: the coat's mirror
//   with the Fresnel reflectance's probability, else the cosine-sampled
//   base) and the GGX rough plastic (7: a VNDF reflection or the base,
//   weighted by the mixture), and the two-sided wrapper (+16: a back hit
//   evaluates the nested lobe in the frame flipped about the surface,
//   wi.z and the sampled wo.z negated, as twosided.cpp).
// A second template parameter, ENV, adds the lat-long environment map
// (instantiated with the diffuse-only and the surface build; a scene of
// codes 1-4 under an environment map takes the surface build): an escaped
// ray adds the map's radiance under MIS against the previous bounce's pdf
// (the TPU kernel's :866-933), the NEE picks one of the (one or two)
// emitters uniformly, reusing its sample for the light's face
// (:1014-1030), and an environment pick draws its candidate here from the
// same (seed, lane, dim) stream, with two binary searches over the map's
// CDFs (ops/megakernel.py env_nee_sample; the TPU kernel reads it from a
// table made outside, :1064-1075).  The builds without ENV keep their code.
// The two smaller builds keep the code of the builds before them, so
// their registers do not move.  A code outside the build's set ends the
// path after its emitter term.  One departure from the TPU kernel, as the
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
              ROUGH_DIELECTRIC = 4, TEX_DIFFUSE = 5, PLASTIC = 6,
              ROUGH_PLASTIC = 7, TWO_SIDED = 16;
// The builds of the bounce body, by lobe set (the file's head)
constexpr int DIFFUSE_BUILD = 0, LOBE_BUILD = 1, SURFACE_BUILD = 2;
// the plastics' coat IOR is kept above 1 (megakernel.py :1207)
constexpr float PLASTIC_ETA_MIN = (float)(1.0 + 1e-4);
// the environment map's meta (ops/megakernel.py ENV_COLS): 0:9 world ->
// env rotation (row major), 9 scale, 10 W, 11 H, 12 texel offset (0: the
// texels lead the arena), 13 CDF offset, 14 the sampling table's total,
// 15 env selection pmf, 16 area selection pmf, 17:26 env -> world rotation
// (row major), 26 the NEE sample's distance 2R
constexpr int ENV_COLS = 32;
constexpr int ENV_TEXEL = 4;  // floats a texel: R, G, B, table cell
// the largest fraction in a Marginal2D cell, 1 - 1e-7 in float32
constexpr float FRAC_MAX = (float)(1.0 - 1e-7);
constexpr float ONE_MINUS_EPS = (float)(1.0 - 1.0 / 16777216.0);
// the uv-area to solid-angle factor 2 pi^2 of the NEE pdf, and the TPU
// kernel's own float32 form of it in the escape pdf (:918)
constexpr float UV_TO_SOLID_ANGLE =
    (float)(2.0 * 3.14159265358979323846 * 3.14159265358979323846);
constexpr float ESCAPE_2PI2 = 2.0f * (PI_F * PI_F);

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

// f x cos (per channel, into f) and pdf of the smooth (rough = false) or
// GGX rough plastic toward the local direction wo, from the face row's
// reflectance R and parameters p = [eta, fdr, nonlinear] (plastic.cpp,
// roughplastic.cpp; the TPU kernel's NEE :1204-1262).  wiz and woz are the
// cosines; wix.. and alpha matter to the rough coat only.
__device__ __forceinline__ float plastic_eval(
    const float* p, const float (&R)[3], bool rough, float wix, float wiy,
    float wiz, float wox, float woy, float woz, float alpha, float (&f)[3]) {
  const float eta_p = fmaxf(p[0], PLASTIC_ETA_MIN);
  float cos_t, eta_it, eta_ti;
  const float F_i = fr_diel(wiz, eta_p, cos_t, eta_it, eta_ti);
  const float F_o = fr_diel(woz, eta_p, cos_t, eta_it, eta_ti);
  const float inv_eta2 = 1.0f / (eta_p * eta_p);
  const float fac = INV_PI * fmaxf(woz, 0.0f) * (1.0f - F_i) * (1.0f - F_o) *
                    inv_eta2;
  for (int c = 0; c < 3; ++c) {
    const float den = 1.0f - (p[2] > 0.5f ? R[c] * p[1] : p[1]);
    f[c] = R[c] / fmaxf(den, 1e-6f) * fac;
  }
  const float cos_pdf = INV_PI * fmaxf(woz, 0.0f);
  if (!rough) return cos_pdf * (1.0f - F_i);
  float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
  const float hn = sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
  hx = hx / hn;
  hy = hy / hn;
  hz = hz / hn;
  const float F_m =
      fr_diel(wix * hx + wiy * hy + wiz * hz, eta_p, cos_t, eta_it, eta_ti);
  const float g2 = ggx_g1(wix, wiy, wiz, hx, hy, hz, alpha) *
                   ggx_g1(wox, woy, woz, hx, hy, hz, alpha);
  const float spec =
      F_m * ggx_d(hx, hy, hz, alpha) * g2 / fmaxf(4.0f * wiz, 1e-20f);
  const float jac =
      1.0f / fmaxf(4.0f * fabsf(wox * hx + woy * hy + woz * hz), 1e-20f);
  for (int c = 0; c < 3; ++c) f[c] = f[c] + spec;
  return F_i * vndf_pdf(wix, wiy, wiz, hx, hy, hz, alpha) * jac +
         (1.0f - F_i) * cos_pdf;
}

// The hit's barycentrics on face `row`, clipped (compute_si mirror).
__device__ __forceinline__ void barycentrics(const float* row, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float& b0,
                                             float& ub, float& vb) {
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = fabsf(det) > DET_EPS ? 1.0f / det : 0.0f;
  const float tvx = ox - row[0], tvy = oy - row[1], tvz = oz - row[2];
  ub = fminf(fmaxf((tvx * pvx + tvy * pvy + tvz * pvz) * inv, 0.0f), 1.0f);
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  vb = fminf(fmaxf((dx * qvx + dy * qvy + dz * qvz) * inv, 0.0f), 1.0f);
  b0 = 1.0f - ub - vb;
}

// BitmapTexture.eval at (u, v) of the texture whose face-row parameters
// are p = [arena offset, W, H, nearest, wrap] (the TPU kernel's _tex_eval
// :705): the arena holds each bitmap channel-planar, R then G then B.  A
// fetch goes through the read-only data cache and stays inside the
// arena's n_tex floats.  Writes the texel value into R.
__device__ __forceinline__ void tex_eval(const float* __restrict__ tex,
                                         int n_tex, const float* p, float u,
                                         float v, float (&R)[3]) {
  const float W = p[1], H = p[2];
  const bool wrap = p[4] > 0.5f;
  const float uu = wrap ? u - floorf(u) : fminf(fmaxf(u, 0.0f), 1.0f);
  const float vv = wrap ? v - floorf(v) : fminf(fmaxf(v, 0.0f), 1.0f);
  const float x = uu * W - 0.5f;
  const float y = (1.0f - vv) * H - 0.5f;
  const int Wi = (int)W, Hi = (int)H, off = (int)p[0];
  const int hw = Wi * Hi;
  auto clip = [](int i, int n) { return min(max(i, 0), n - 1); };
  auto fetch = [&](int i) { return __ldg(tex + clip(i, n_tex)); };
  if (p[3] > 0.5f) {  // nearest
    const int at = clip((int)rintf(y), Hi) * Wi + clip((int)rintf(x), Wi);
    for (int c = 0; c < 3; ++c) R[c] = fetch(off + c * hw + at);
    return;
  }
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = clip((int)x0, Wi), x1i = clip(x0i + 1, Wi);
  const int y0i = clip((int)y0, Hi), y1i = clip(y0i + 1, Hi);
  for (int c = 0; c < 3; ++c) {
    const int po = off + c * hw;
    const float b00 = fetch(po + y0i * Wi + x0i);
    const float b10 = fetch(po + y0i * Wi + x1i);
    const float b01 = fetch(po + y1i * Wi + x0i);
    const float b11 = fetch(po + y1i * Wi + x1i);
    R[c] = b00 * (1 - fx) * (1 - fy) + b10 * fx * (1 - fy) +
           b01 * (1 - fx) * fy + b11 * fx * fy;
  }
}

// The environment map a bounce reads (ops/megakernel.py pack_env): its
// arena (H x W texels of ENV_TEXEL floats, 16-byte aligned, then the
// marginal CDF (H), the row weights (H) and the conditional CDFs (H x W)),
// the meta by value, and the map's index among the emitters.  The arena is
// read through the read-only data cache.
struct EnvMap {
  const float* data;
  float m[ENV_COLS];
  int pos;
};

// The EnvMap of a C entry's arguments: the arena `data` of n_data floats,
// a host pointer to the meta and the map's position; false when the meta
// and the arena's length do not agree.  Without a map (null data) it is
// empty, and true.
inline bool env_map(const float* data, int n_data, const float* meta,
                    int pos, EnvMap& e) {
  e.data = data;
  e.pos = pos;
  for (int k = 0; k < ENV_COLS; ++k) e.m[k] = meta ? meta[k] : 0.0f;
  if (data == nullptr) return true;
  const long W = (long)e.m[10], H = (long)e.m[11];
  return meta != nullptr && W > 0 && H > 0 && (pos == 0 || pos == 1) &&
         (long)n_data == H * ((ENV_TEXEL + 1) * W + 2) &&
         (reinterpret_cast<uintptr_t>(data) & 15) == 0;
}

// Bilinear radiance of the map at lat-long (u, v), times its scale: x
// wraps, y clamps (EnvmapEmitter._bilinear); each tap is one 16-byte load.
__device__ __forceinline__ void env_radiance(const EnvMap& e, float u,
                                             float v, float (&le)[3]) {
  const float Wf = e.m[10], Hf = e.m[11];
  const int W = (int)Wf, H = (int)Hf;
  const float4* texel = reinterpret_cast<const float4*>(e.data);
  const float x = u * Wf - 0.5f, y = v * Hf - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  int x0i = (int)x0 % W;
  if (x0i < 0) x0i += W;
  const int x1i = (x0i + 1) % W;
  const int y0i = min(max((int)y0, 0), H - 1);
  const int y1i = min(y0i + 1, H - 1);
  const float4 t00 = __ldg(texel + y0i * W + x0i);
  const float4 t10 = __ldg(texel + y0i * W + x1i);
  const float4 t01 = __ldg(texel + y1i * W + x0i);
  const float4 t11 = __ldg(texel + y1i * W + x1i);
  le[0] = (t00.x * (1.0f - fx) * (1.0f - fy) + t10.x * fx * (1.0f - fy) +
           t01.x * (1.0f - fx) * fy + t11.x * fx * fy) * e.m[9];
  le[1] = (t00.y * (1.0f - fx) * (1.0f - fy) + t10.y * fx * (1.0f - fy) +
           t01.y * (1.0f - fx) * fy + t11.y * fx * fy) * e.m[9];
  le[2] = (t00.z * (1.0f - fx) * (1.0f - fy) + t10.z * fx * (1.0f - fy) +
           t01.z * (1.0f - fx) * fy + t11.z * fx * fy) * e.m[9];
}

// The sampling table's cell (row, col): the texel's fourth float.
__device__ __forceinline__ float env_cell(const EnvMap& e, int row, int col) {
  return __ldg(e.data + ENV_TEXEL * (row * (int)e.m[10] + col) + 3);
}

// The entries of a[0..n) below u: a lower bound by binary search, which is
// the JAX package's count, since the CDFs never decrease.
__device__ __forceinline__ int count_below(const float* a, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The environment map's NEE candidate of the 2D sample (ue1, ue2)
// (ops/megakernel.py env_nee_sample: Marginal2D.sample -> _uv_to_dir ->
// the spawn_ray_to renormalisation): the unit direction, the pdf times the
// selection pmf, Le / pdf / selection pmf, and the shadow ray's maxt.
__device__ __forceinline__ void env_nee(const EnvMap& e, float ue1,
                                        float ue2, float& sdx, float& sdy,
                                        float& sdz, float& pdf_eff,
                                        float (&w)[3], float& maxt) {
  const float* m = e.m;
  const float Wf = m[10], Hf = m[11], tot = m[14];
  const int W = (int)Wf, H = (int)Hf;
  const float* row_cdf = e.data + (int)m[13];
  const float* row_w = row_cdf + H;
  const float* cond = row_w + H;
  // the row from the marginal and u[1], the column from its conditional
  // and u[0] (Marginal2D.sample)
  const int row = min(count_below(row_cdf, H, ue2), H - 1);
  const float lo_r = row > 0 ? __ldg(row_cdf + row - 1) : 0.0f;
  const float rw = __ldg(row_w + row);
  const float v_frac =
      fminf(fmaxf(safe_div(ue2 - lo_r, safe_div(rw, tot)), 0.0f), FRAC_MAX);
  const float v = ((float)row + v_frac) / Hf;
  const float* crow = cond + (size_t)row * W;
  const int col = min(count_below(crow, W, ue1), W - 1);
  const float lo_c = col > 0 ? __ldg(crow + col - 1) : 0.0f;
  const float u_frac = fminf(
      fmaxf(safe_div(ue1 - lo_c, safe_div(env_cell(e, row, col), rw)), 0.0f),
      FRAC_MAX);
  const float u = ((float)col + u_frac) / Wf;
  // Marginal2D.pdf at (u, v)
  const int pc = min(max((int)(u * Wf), 0), W - 1);
  const int pr = min(max((int)(v * Hf), 0), H - 1);
  const float pdf_uv = safe_div(env_cell(e, pr, pc) * (Wf * Hf), tot);
  // the direction (_uv_to_dir), in the world
  const float phi = TWO_PI * u, theta = PI_F * v;
  const float st = sinf(theta), ct = cosf(theta);
  const float lx = st * sinf(phi), ly = ct, lz = -st * cosf(phi);
  const float* R = m + 17;
  const float dx = lx * R[0] + ly * R[1] + lz * R[2];
  const float dy = lx * R[3] + ly * R[4] + lz * R[5];
  const float dz = lx * R[6] + ly * R[7] + lz * R[8];
  const float pdf = safe_div(pdf_uv, UV_TO_SOLID_ANGLE * fmaxf(st, 1e-6f));
  float le[3];
  env_radiance(e, u, v, le);
  // the shadow ray toward the point at 2R, renormalised (spawn_ray_to)
  const float ex = dx * m[26], ey = dy * m[26], ez = dz * m[26];
  const float dist = sqrtf(fmaxf(ex * ex + ey * ey + ez * ez, 1e-20f));
  sdx = ex / dist;
  sdy = ey / dist;
  sdz = ez / dist;
  maxt = dist * (float)(1.0 - 1e-3);
  const float sel = m[15];
  const float inv_sel = 1.0f / fmaxf(sel, 1e-20f);
  pdf_eff = pdf * sel;
  for (int c = 0; c < 3; ++c)
    w[c] = (pdf > 0.0f ? le[c] / fmaxf(pdf, 1e-20f) : 0.0f) * inv_sel;
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
// `code` (0-4, and 6-7 in the surface build); the frame (s, t, sh) and, on
// a GGX face, the local wi and alpha are the bounce's.  `refl` is the
// diffuse reflectance (the row's, or the texel's), `cos_wi_sgn` the signed
// cosine of the mirror direction and `cos_wi` the lobe's (flipped on a
// two-sided back hit, `flip`, whose sampled local z flips back).
template <int LOBES>
__device__ __forceinline__ void sample_lobe(
    int code, uint32_t seed_x, uint32_t lane, uint32_t dbase, float dx,
    float dy, float dz, float cos_wi_sgn, float cos_wi, bool flip, float shx,
    float shy, float shz, float sx, float sy, float sz, float tx, float ty,
    float tz, float wix, float wiy, float wiz, float alpha, const float* row,
    const float* refl, float px, float py, float pz, float off, float ngx,
    float ngy, float ngz, int depth, int rr_depth, PathState& s) {
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
    wR = refl[0];
    wG = refl[1];
    wB = refl[2];
    pdf_fwd = INV_PI * lz;
  } else if (code == CONDUCTOR || code == DIELECTRIC) {
    local = false;
    delta = true;
    // the mirror direction, world form
    const float rx = dx + 2.0f * cos_wi_sgn * shx;
    const float ry = dy + 2.0f * cos_wi_sgn * shy;
    const float rz = dz + 2.0f * cos_wi_sgn * shz;
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
  } else if (LOBES == SURFACE_BUILD && code >= PLASTIC) {
    // SmoothPlastic / RoughPlastic.sample (:1403-1486): the coat's
    // reflection with the Fresnel reflectance's probability, else the
    // cosine-sampled base; p = [eta, fdr, nonlinear]
    const float* p = row + 18;
    const float eta_p = fmaxf(p[0], PLASTIC_ETA_MIN);
    float cos_t, eta_it, eta_ti;
    const float F_i = fr_diel(cos_wi, eta_p, cos_t, eta_it, eta_ti);
    const bool pick = u_lobe < F_i;
    const float inv_eta2 = 1.0f / (eta_p * eta_p);
    float base[3];
    for (int c = 0; c < 3; ++c)
      base[c] = refl[c] /
                fmaxf(1.0f - (p[2] > 0.5f ? refl[c] * p[1] : p[1]), 1e-6f);
    if (code == PLASTIC && pick) {  // the coat's mirror, a Dirac lobe
      local = false;
      delta = true;
      ndx = dx + 2.0f * cos_wi_sgn * shx;
      ndy = dy + 2.0f * cos_wi_sgn * shy;
      ndz = dz + 2.0f * cos_wi_sgn * shz;
      wR = wG = wB = 1.0f;
      pdf_fwd = F_i;
    } else if (code == PLASTIC) {  // the base
      cosine_hemisphere(ub1, ub2, lx, ly, lz);
      const float wdf =
          inv_eta2 * (1.0f - fr_diel(lz, eta_p, cos_t, eta_it, eta_ti));
      wR = base[0] * wdf;
      wG = base[1] * wdf;
      wB = base[2] * wdf;
      pdf_fwd = INV_PI * lz * (1.0f - F_i);
    } else {  // the GGX coat or the base; weight = the mixture's f / pdf
      if (pick) {
        float mx, my, mz;
        vndf_sample(wix, wiy, wiz, ub1, ub2, alpha, mx, my, mz);
        const float cim = wix * mx + wiy * my + wiz * mz;
        lx = 2.0f * cim * mx - wix;
        ly = 2.0f * cim * my - wiy;
        lz = 2.0f * cim * mz - wiz;
      } else {
        cosine_hemisphere(ub1, ub2, lx, ly, lz);
      }
      float hx = wix + lx, hy = wiy + ly, hz = wiz + lz;
      const float hn = sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
      hx = hx / hn;
      hy = hy / hn;
      hz = hz / hn;
      const float F_m = fr_diel(wix * hx + wiy * hy + wiz * hz, eta_p,
                                cos_t, eta_it, eta_ti);
      const float g2 = ggx_g1(wix, wiy, wiz, hx, hy, hz, alpha) *
                       ggx_g1(lx, ly, lz, hx, hy, hz, alpha);
      const float spec =
          F_m * ggx_d(hx, hy, hz, alpha) * g2 / fmaxf(4.0f * wiz, 1e-20f);
      const float F_o = fr_diel(lz, eta_p, cos_t, eta_it, eta_ti);
      const float fac = INV_PI * fmaxf(lz, 0.0f) * (1.0f - F_i) *
                        (1.0f - F_o) * inv_eta2;
      const float jac =
          1.0f / fmaxf(4.0f * fabsf(lx * hx + ly * hy + lz * hz), 1e-20f);
      const float pdf = F_i * vndf_pdf(wix, wiy, wiz, hx, hy, hz, alpha) *
                            jac +
                        (1.0f - F_i) * INV_PI * fmaxf(lz, 0.0f);
      const bool ok = wiz > 0.0f && lz > 0.0f && pdf > 1e-20f;
      const float inv_pdf = ok ? 1.0f / fmaxf(pdf, 1e-20f) : 0.0f;
      wR = (base[0] * fac + spec) * inv_pdf;
      wG = (base[1] * fac + spec) * inv_pdf;
      wB = (base[2] * fac + spec) * inv_pdf;
      pdf_fwd = ok ? pdf : 0.0f;
    }
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
    // a two-sided back hit's local z flips back (not the rough
    // dielectric's, as the TPU kernel's :1398)
    const float lzw = flip && code != ROUGH_DIELECTRIC ? -lz : lz;
    ndx = sx * lx + tx * ly + shx * lzw;
    ndy = sy * lx + ty * ly + shy * lzw;
    ndz = sz * lx + tz * ly + shz * lzw;
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

// The environment's radiance along the escaped ray d, under MIS against
// the previous bounce's pdf (the TPU kernel's :866-933; its arithmetic,
// with the rotation, 1 / pi and its float32 2 pi^2 as there).
__device__ __forceinline__ void env_escape(const EnvMap& e, float dx,
                                           float dy, float dz,
                                           PathState& s) {
  const float* m = e.m;
  const float ex = m[0] * dx + m[1] * dy + m[2] * dz;
  const float ey = m[3] * dx + m[4] * dy + m[5] * dz;
  const float ez = m[6] * dx + m[7] * dy + m[8] * dz;
  float u = atan2f(ex, -ez) * (float)(0.5 / 3.14159265358979323846);
  u = u - floorf(u);
  const float v = acosf(fminf(fmaxf(ey, -1.0f), 1.0f)) *
                  (float)(1.0 / 3.14159265358979323846);
  float le[3];
  env_radiance(e, u, v, le);
  const float Wf = m[10], Hf = m[11], tot = m[14];
  const int ce = min(max((int)(u * Wf), 0), (int)Wf - 1);
  const int re = min(max((int)(v * Hf), 0), (int)Hf - 1);
  const float pdf_uv =
      fabsf(tot) > 1e-20f ? env_cell(e, re, ce) * (Wf * Hf) / tot : 0.0f;
  const float ct = cosf(PI_F * v);
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 1e-12f));
  const float pdf_env = pdf_uv / (ESCAPE_2PI2 * fmaxf(st, 1e-6f)) * m[15];
  const float m_esc = s.prev_delta ? 1.0f : mis(s.prev_pdf, pdf_env);
  s.Lr = s.Lr + s.Br * (le[0] * m_esc);
  s.Lg = s.Lg + s.Bg * (le[1] * m_esc);
  s.Lb = s.Lb + s.Bb * (le[2] * m_esc);
}

// One bounce of an active lane at `depth`.  On return s.act says whether
// the path goes on; when it is false only L is meaningful.  `tris` is
// pack_scene's face table in face order; `tex` its texture arena of n_tex
// floats (the surface build's textured faces read it; null elsewhere);
// `env` the environment map (read only by the ENV builds); `lt` the light
// table.  LOBES: the lobe set, ENV: the environment map's branches (the
// file's head).
template <int LOBES, bool ENV, class Query>
__device__ __forceinline__ void bounce(const Query& q,
                                       const float* __restrict__ tris,
                                       const float* __restrict__ tex,
                                       int n_tex, const EnvMap& env,
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
  if (best < 0) {  // miss: only the environment reaches this lane
    if constexpr (ENV) env_escape(env, dx, dy, dz, s);
    s.act = false;
    return;
  }
  const float* row = tris + (size_t)best * TRI_COLS;
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  float R[3] = {row[9], row[10], row[11]};
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
  // the surface build reads the face's code here: a textured face (5, 21)
  // takes its reflectance from the arena and goes on as 0 or 16
  int scode = 0;
  if constexpr (LOBES == SURFACE_BUILD) scode = (int)rintf(row[17]);
  const bool tex_face =
      LOBES == SURFACE_BUILD &&
      (scode == TEX_DIFFUSE || scode == TEX_DIFFUSE + TWO_SIDED);
  float shx = ngx, shy = ngy, shz = ngz;
  if (smooth || tex_face) {
    // the winner's barycentrics, clipped (compute_si mirror)
    float b0, ub, vb;
    barycentrics(row, ox, oy, oz, dx, dy, dz, b0, ub, vb);
    if (tex_face) {
      const float u = row[24] * b0 + row[26] * ub + row[28] * vb;
      const float v = row[25] * b0 + row[27] * ub + row[29] * vb;
      tex_eval(tex, n_tex, row + 18, u, v, R);
      scode -= TEX_DIFFUSE;
    }
    if (smooth) {
      // the interpolated shading normal; flat faces store ng at all 3
      // slots
      const float nsx = row[30] * b0 + row[33] * ub + row[36] * vb;
      const float nsy = row[31] * b0 + row[34] * ub + row[37] * vb;
      const float nsz = row[32] * b0 + row[35] * ub + row[38] * vb;
      const float n2 = nsx * nsx + nsy * nsy + nsz * nsz;
      const float rinv =
          n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
      shx = nsx * rinv;
      shy = nsy * rinv;
      shz = nsz * rinv;
    }
  }
  const float Rr = R[0], Rg = R[1], Rb = R[2];

  const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
  const float cos_wi_sgn = -(dx * shx + dy * shy + dz * shz);
  // the two-sided wrapper: a back hit flips the nested lobe's frame
  bool flip = false;
  if constexpr (LOBES == SURFACE_BUILD) {
    if (scode >= TWO_SIDED) {
      scode -= TWO_SIDED;
      flip = cos_wi_sgn < 0.0f;
    }
  }
  const float cos_wi = flip ? -cos_wi_sgn : cos_wi_sgn;
  const float cos_geo = -(dx * ngx + dy * ngy + dz * ngz);
  const bool front = cos_wi > 0.0f;

  // ---- MIS'd radiance of a directly hit emitter (path.py:82); the
  // face table's emission column is exactly is_light * Le
  if (front && IsL > 0.5f) {
    const float dist2 = t * t;
    float pdf_hit =
        cos_geo > 1e-6f ? PdfA * dist2 / fmaxf(cos_geo, 1e-6f) : 0.0f;
    if constexpr (ENV) pdf_hit = pdf_hit * env.m[16];  // area selection pmf
    const float m_h = s.prev_delta ? 1.0f : mis(s.prev_pdf, pdf_hit);
    const float Ler0 = n_lights > 0 ? lt[14] : 0.0f;
    const float Leg0 = n_lights > 0 ? lt[15] : 0.0f;
    const float Leb0 = n_lights > 0 ? lt[16] : 0.0f;
    s.Lr = s.Lr + s.Br * (IsL * Ler0) * m_h;
    s.Lg = s.Lg + s.Bg * (IsL * Leg0) * m_h;
    s.Lb = s.Lb + s.Bb * (IsL * Leb0) * m_h;
  }
  // the face's lobe; the dielectrics are two-sided
  const int code = LOBES == SURFACE_BUILD ? scode
                   : LOBES                ? (int)rintf(row[17])
                                          : 0;
  const bool two_sided = code == DIELECTRIC || code == ROUGH_DIELECTRIC;
  const int last_code =
      LOBES == SURFACE_BUILD ? ROUGH_PLASTIC : ROUGH_DIELECTRIC;
  if (!(front || two_sided) || depth + 1 >= max_depth ||
      (unsigned)code > (unsigned)last_code) {
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
  const bool ggx = code == ROUGH_CONDUCTOR || code == ROUGH_DIELECTRIC ||
                   (LOBES == SURFACE_BUILD && code == ROUGH_PLASTIC);
  float wix = 0.0f, wiy = 0.0f, alpha = 0.0f;
  if (ggx) {
    wix = -(dx * sx + dy * sy + dz * sz);
    wiy = -(dx * tx + dy * ty + dz * tz);
    alpha = fmaxf(PdfA, 1e-4f);
  }
  const float wiz = cos_wi;

  // ---- NEE toward the area light or the environment (path.py:92-105)
  {
    const float u_sel = rng1(seed_x, lane, dbase + SLOT_EM_SELECT);
    float ue1, ue2;
    rng2(seed_x, lane, dbase + SLOT_EM_POS, ue1, ue2);
    // the uniform pick of one of the (one or two) emitters, reusing u_sel
    // for the light's face (sample_reuse_pmf; :1014-1030)
    float u_face = u_sel;
    bool pick_env = false;
    if constexpr (ENV) {
      if (n_lights > 0) {
        const bool second = u_sel > 0.5f;
        pick_env = env.pos == 1 ? second : !second;
        u_face = fminf(fmaxf((u_sel - (second ? 0.5f : 0.0f)) / 0.5f, 0.0f),
                       ONE_MINUS_EPS);
      } else {
        pick_env = true;
        u_face = fminf(fmaxf(u_sel, 0.0f), ONE_MINUS_EPS);
      }
    }
    int idx = 0;
    for (int j = 0; j < n_lights; ++j)
      idx += lt[j * LIGHT_COLS + 12] < u_face ? 1 : 0;
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
    float maxt_s = sdist * (float)(1.0 - 1e-3);
    // the pdf of the pick (selection pmf included) and, with ENV, its
    // weight Le / pdf: the environment's candidate or the light's sample
    float pdf_eff = pdf_nee;
    float wn[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (ENV) {
      if (pick_env) {
        env_nee(env, ue1, ue2, sdx, sdy, sdz, pdf_eff, wn, maxt_s);
      } else {
        const float sel_area = env.m[16];
        pdf_eff = pdf_nee * sel_area;
        const float inv_pa = 1.0f / (fmaxf(pdf_nee, 1e-20f) * sel_area);
        for (int c = 0; c < 3; ++c) wn[c] = lr[14 + c] * inv_pa;
      }
    }
    const float cos_s_sgn = sdx * shx + sdy * shy + sdz * shz;
    // the flipped frame's wo.z on a two-sided back hit
    const float cos_s = flip ? -cos_s_sgn : cos_s_sgn;
    if constexpr (LOBES != DIFFUSE_BUILD) {
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
      } else if (LOBES == SURFACE_BUILD && code >= PLASTIC) {
        // SmoothPlastic / RoughPlastic eval (:1204-1262)
        ok = front && cos_s > 0.0f;
        float f[3];
        const bool rough = code == ROUGH_PLASTIC;
        f_pdf = plastic_eval(
            row + 18, R, rough, wix, wiy, wiz,
            rough ? sdx * sx + sdy * sy + sdz * sz : 0.0f,
            rough ? sdx * tx + sdy * ty + sdz * tz : 0.0f, cos_s, alpha, f);
        fr = f[0];
        fg = f[1];
        fb = f[2];
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
      if (ok && pdf_eff > 0.0f) {
        const float sgn_s =
            sdx * ngx + sdy * ngy + sdz * ngz >= 0.0f ? 1.0f : -1.0f;
        const float sox = px + sgn_s * off * ngx;
        const float soy = py + sgn_s * off * ngy;
        const float soz = pz + sgn_s * off * ngz;
        if (!q.occluded(sox, soy, soz, sdx, sdy, sdz, maxt_s)) {
          if constexpr (ENV) {
            const float wnee = mis(pdf_eff, f_pdf);
            s.Lr = s.Lr + s.Br * (fr * wnee * wn[0]);
            s.Lg = s.Lg + s.Bg * (fg * wnee * wn[1]);
            s.Lb = s.Lb + s.Bb * (fb * wnee * wn[2]);
          } else {
            const float inv_pa = 1.0f / fmaxf(pdf_nee, 1e-20f);
            const float wnee = mis(pdf_nee, f_pdf);
            s.Lr = s.Lr + s.Br * (fr * wnee * (lr[14] * inv_pa));
            s.Lg = s.Lg + s.Bg * (fg * wnee * (lr[15] * inv_pa));
            s.Lb = s.Lb + s.Bb * (fb * wnee * (lr[16] * inv_pa));
          }
        }
      }
    } else if (pdf_eff > 0.0f && cos_s > 0.0f) {
      // the shadow ray leaves on the side of the GEOMETRIC normal
      const float sgn_s =
          sdx * ngx + sdy * ngy + sdz * ngz >= 0.0f ? 1.0f : -1.0f;
      const float sox = px + sgn_s * off * ngx;
      const float soy = py + sgn_s * off * ngy;
      const float soz = pz + sgn_s * off * ngz;
      if (!q.occluded(sox, soy, soz, sdx, sdy, sdz, maxt_s)) {
        const float f_pdf = INV_PI * fmaxf(cos_s, 0.0f);
        const float c = INV_PI * cos_s;
        if constexpr (ENV) {
          const float wnee = mis(pdf_eff, f_pdf);
          s.Lr = s.Lr + s.Br * (Rr * c * wnee * wn[0]);
          s.Lg = s.Lg + s.Bg * (Rg * c * wnee * wn[1]);
          s.Lb = s.Lb + s.Bb * (Rb * c * wnee * wn[2]);
        } else {
          const float inv_pa = 1.0f / fmaxf(pdf_nee, 1e-20f);
          const float wnee = mis(pdf_nee, f_pdf);
          s.Lr = s.Lr + s.Br * (Rr * c * wnee * (lr[14] * inv_pa));
          s.Lg = s.Lg + s.Bg * (Rg * c * wnee * (lr[15] * inv_pa));
          s.Lb = s.Lb + s.Bb * (Rb * c * wnee * (lr[16] * inv_pa));
        }
      }
    }
  }

  if constexpr (LOBES != DIFFUSE_BUILD) {
    // the lobe build reads the row's reflectance again, as it did before
    // the surface build; the surface build passes the texel's
    sample_lobe<LOBES>(code, seed_x, lane, dbase, dx, dy, dz, cos_wi_sgn,
                       cos_wi, flip, shx, shy, shz, sx, sy, sz, tx, ty, tz,
                       wix, wiy, wiz, alpha, row,
                       LOBES == SURFACE_BUILD ? R : row + 9, px, py, pz, off,
                       ngx, ngy, ngz, depth, rr_depth, s);
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
template <int LOBES, bool ENV, class Query>
__device__ __forceinline__ void trace_paths(
    const Query& q, const float* __restrict__ tris,
    const float* __restrict__ tex, int n_tex, const EnvMap& env,
    const float* lt, int n_lights,
    bool smooth, uint32_t seed, const int32_t* __restrict__ lanes,
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
      bounce<LOBES, ENV>(q, tris, tex, n_tex, env, lt, n_lights, smooth,
                         seed_x, lane_id, depth, max_depth, rr_depth, s);
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
