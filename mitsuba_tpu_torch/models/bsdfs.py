"""BSDFs (mitsuba_tpu/models/bsdfs.py): diffuse, smooth and GGX rough
conductors and dielectrics, smooth and GGX rough plastic, and the
two-sided wrapper.

All directions are in the local shading frame (z = normal) and ``si.wi``
points away from the surface.  ``eval`` returns f * |cos_theta_o| and is
zero for a delta lobe; ``sample`` returns (BSDFSample, eval / pdf), for a
delta lobe the lobe's value over its discrete choice probability, as in
the reference.  A refraction scales radiance by eta_ti^2.  The
megakernels (ops/megakernel.py) carry the same lobes in their own body.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from ..core import warp
from ..core.fresnel import fresnel_conductor, fresnel_dielectric, refract
from ..core.math import Frame, dot, mulsign, reflect
from ..core.records import BSDFSample, select
from . import microfacet as mf


class Flags:
    """BSDFFlags, the subset of bsdf.h:13 that the ported lobes use."""

    DiffuseReflection = 1 << 0
    GlossyReflection = 1 << 1
    DeltaReflection = 1 << 2
    DeltaTransmission = 1 << 3
    GlossyTransmission = 1 << 4


def _flags(shape, value, device):
    return torch.full(shape, value, dtype=torch.int64, device=device)


def _pick_flags(pick_reflect, refl, trans):
    return torch.where(pick_reflect, refl, trans).to(torch.int64)


def _zeros_eval_pdf(wo):
    return (torch.zeros(wo.shape[:-1] + (3,), device=wo.device),
            torch.zeros(wo.shape[:-1], device=wo.device))


@dataclass
class SmoothDiffuse:
    """Lambertian reflection (src/bsdfs/diffuse.cpp)."""

    reflectance: object   # texture

    flags = Flags.DiffuseReflection

    def sample(self, si, sample1, sample2, active):
        cos_i = Frame.cos_theta(si.wi)
        wo = warp.square_to_cosine_hemisphere(sample2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        ok = active & (cos_i > 0.0) & (pdf > 0.0)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
            delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
            sampled_type=_flags(pdf.shape, Flags.DiffuseReflection,
                                pdf.device))
        return bs, torch.where(ok[..., None], self.reflectance.eval(si), 0.0)

    def _ok(self, si, wo, active):
        return active & (Frame.cos_theta(si.wi) > 0.0) \
            & (Frame.cos_theta(wo) > 0.0)

    def eval(self, si, wo, active):
        val = self.reflectance.eval(si) * (
            warp.INV_PI * torch.clamp(Frame.cos_theta(wo), min=0.0))[..., None]
        return torch.where(self._ok(si, wo, active)[..., None], val, 0.0)

    def pdf(self, si, wo, active):
        return torch.where(self._ok(si, wo, active),
                           warp.square_to_cosine_hemisphere_pdf(wo), 0.0)

    def eval_pdf(self, si, wo, active):
        return self.eval(si, wo, active), self.pdf(si, wo, active)


@dataclass
class SmoothConductor:
    """Perfect mirror with conductor Fresnel (src/bsdfs/conductor.cpp)."""

    eta: torch.Tensor   # (3,) real part of the IOR, one a channel
    k: torch.Tensor     # (3,) imaginary part
    specular_reflectance: object = None   # optional texture

    flags = Flags.DeltaReflection

    def sample(self, si, sample1, sample2, active):
        cos_i = Frame.cos_theta(si.wi)
        ok = active & (cos_i > 0.0)
        f = fresnel_conductor(cos_i, self.eta, self.k)
        if self.specular_reflectance is not None:
            f = f * self.specular_reflectance.eval(si)
        bs = BSDFSample(
            wo=reflect(si.wi), pdf=torch.where(ok, 1.0, 0.0),
            eta=torch.ones_like(cos_i),
            delta=torch.ones(cos_i.shape, dtype=torch.bool,
                             device=cos_i.device),
            sampled_type=_flags(cos_i.shape, Flags.DeltaReflection,
                                cos_i.device))
        return bs, torch.where(ok[..., None], f, 0.0)

    def eval(self, si, wo, active):
        return _zeros_eval_pdf(wo)[0]

    def pdf(self, si, wo, active):
        return _zeros_eval_pdf(wo)[1]

    def eval_pdf(self, si, wo, active):
        return _zeros_eval_pdf(wo)


@dataclass
class SmoothDielectric:
    """Smooth dielectric interface (src/bsdfs/dielectric.cpp)."""

    eta: torch.Tensor   # () relative IOR int / ext
    specular_reflectance: object = None
    specular_transmittance: object = None

    flags = Flags.DeltaReflection | Flags.DeltaTransmission

    def sample(self, si, sample1, sample2, active):
        cos_i = Frame.cos_theta(si.wi)
        f, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_i, self.eta)
        pick_reflect = sample1 <= f
        wo = torch.where(pick_reflect[..., None], reflect(si.wi),
                         refract(si.wi, cos_t, eta_ti))
        pdf = torch.where(pick_reflect, f, 1.0 - f)
        # radiance scales by 1 / eta_rel^2 across a refraction
        w = torch.where(pick_reflect, 1.0, torch.square(eta_ti))
        weight = w[..., None].expand(w.shape + (3,))
        if self.specular_reflectance is not None:
            weight = torch.where(pick_reflect[..., None],
                                 weight * self.specular_reflectance.eval(si),
                                 weight)
        if self.specular_transmittance is not None:
            weight = torch.where(pick_reflect[..., None], weight,
                                 weight * self.specular_transmittance.eval(si))
        ok = active & (pdf > 0.0)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0),
            eta=torch.where(pick_reflect, 1.0, eta_it),
            delta=torch.ones(pdf.shape, dtype=torch.bool, device=pdf.device),
            sampled_type=_pick_flags(pick_reflect, Flags.DeltaReflection,
                                     Flags.DeltaTransmission))
        return bs, torch.where(ok[..., None], weight, 0.0)

    def eval(self, si, wo, active):
        return _zeros_eval_pdf(wo)[0]

    def pdf(self, si, wo, active):
        return _zeros_eval_pdf(wo)[1]

    def eval_pdf(self, si, wo, active):
        return _zeros_eval_pdf(wo)


@dataclass
class RoughConductor:
    """GGX rough conductor with VNDF sampling (src/bsdfs/roughconductor.cpp)."""

    eta: torch.Tensor     # (3,)
    k: torch.Tensor       # (3,)
    alpha: torch.Tensor   # () isotropic roughness
    specular_reflectance: object = None

    flags = Flags.GlossyReflection

    def _a(self):
        return torch.clamp(torch.as_tensor(self.alpha), min=1e-4)

    def sample(self, si, sample1, sample2, active):
        a = self._a()
        cos_i = Frame.cos_theta(si.wi)
        m = mf.sample_vndf(si.wi, sample2, a, a)
        wo = 2.0 * dot(si.wi, m, keepdim=True) * m - si.wi
        ok = active & (cos_i > 0.0) & (Frame.cos_theta(wo) > 0.0)
        pdf = mf.vndf_pdf(si.wi, m, a, a) / torch.clamp(
            4.0 * torch.abs(dot(wo, m)), min=1e-20)
        # f cos / pdf simplifies to F G2 / G1(wi)
        f_fres = fresnel_conductor(dot(si.wi, m), self.eta, self.k)
        g2 = mf.smith_g2(si.wi, wo, m, a, a)
        g1 = mf.smith_g1(si.wi, m, a, a)
        weight = f_fres * torch.where(g1 > 0.0,
                                      g2 / torch.clamp(g1, min=1e-20),
                                      0.0)[..., None]
        if self.specular_reflectance is not None:
            weight = weight * self.specular_reflectance.eval(si)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
            delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
            sampled_type=_flags(pdf.shape, Flags.GlossyReflection,
                                pdf.device))
        return bs, torch.where(ok[..., None], weight, 0.0)

    def _half(self, si, wo):
        cos_i = Frame.cos_theta(si.wi)
        ok = (cos_i > 0.0) & (Frame.cos_theta(wo) > 0.0)
        m = si.wi + wo
        m = m / torch.sqrt(torch.clamp(torch.sum(m * m, dim=-1, keepdim=True),
                                       min=1e-20))
        return cos_i, ok, m

    def eval(self, si, wo, active):
        a = self._a()
        cos_i, ok, m = self._half(si, wo)
        val = fresnel_conductor(dot(si.wi, m), self.eta, self.k) * (
            mf.ggx_D(m, a, a) * mf.smith_g2(si.wi, wo, m, a, a)
            / torch.clamp(4.0 * cos_i, min=1e-20))[..., None]
        if self.specular_reflectance is not None:
            val = val * self.specular_reflectance.eval(si)
        return torch.where((active & ok)[..., None], val, 0.0)

    def pdf(self, si, wo, active):
        a = self._a()
        _, ok, m = self._half(si, wo)
        pdf = mf.vndf_pdf(si.wi, m, a, a) / torch.clamp(
            4.0 * torch.abs(dot(wo, m)), min=1e-20)
        return torch.where(active & ok, pdf, 0.0)

    def eval_pdf(self, si, wo, active):
        return self.eval(si, wo, active), self.pdf(si, wo, active)


# RGB IOR presets of common conductors (the reference ships spectral
# .eta/.k files; these are their sRGB-integrated equivalents)
CONDUCTOR_IOR = {
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Ag": ((0.1552, 0.1167, 0.1383), (4.8283, 3.1222, 2.1457)),
    "Al": ((1.6574, 0.8803, 0.5212), (9.2238, 6.2692, 4.8370)),
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}


@dataclass
class RoughDielectric:
    """GGX rough dielectric with visible-normal sampling
    (src/bsdfs/roughdielectric.cpp)."""

    eta: torch.Tensor     # () relative IOR int / ext
    alpha: torch.Tensor   # () isotropic roughness
    specular_reflectance: object = None
    specular_transmittance: object = None

    flags = Flags.GlossyReflection | Flags.GlossyTransmission

    def _a(self):
        return torch.clamp(torch.as_tensor(self.alpha), min=1e-4)

    def sample(self, si, sample1, sample2, active):
        a = self._a()
        cos_i = Frame.cos_theta(si.wi)
        # flip so the VNDF sampler sees an upper-hemisphere direction
        wi_f = mulsign(si.wi, cos_i[..., None])
        m = mf.sample_vndf(wi_f, sample2, a, a)
        m_o = mulsign(m, cos_i[..., None])   # toward the incident side
        cos_im = dot(si.wi, m_o)
        f, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_im, self.eta)
        pick_reflect = sample1 <= f
        wo = torch.where(pick_reflect[..., None],
                         2.0 * cos_im[..., None] * m_o - si.wi,
                         refract_about(si.wi, m_o, cos_t, eta_ti))

        # weight: G2 / G1 (VNDF); the lobe choice cancels the Fresnel term
        g1 = mf.smith_g1(wi_f, m, a, a)
        wo_f = mulsign(wo, Frame.cos_theta(wo)[..., None])
        g2 = g1 * mf.smith_g1(wo_f, m, a, a)
        w = torch.where(g1 > 0.0, g2 / torch.clamp(g1, min=1e-20), 0.0)
        w = torch.where(pick_reflect, w, w * torch.square(eta_ti))
        weight = w[..., None].expand(w.shape + (3,))
        if self.specular_reflectance is not None:
            weight = torch.where(pick_reflect[..., None],
                                 weight * self.specular_reflectance.eval(si),
                                 weight)
        if self.specular_transmittance is not None:
            weight = torch.where(pick_reflect[..., None], weight,
                                 weight * self.specular_transmittance.eval(si))

        # pdf: VNDF pdf x the chosen mapping's jacobian x lobe probability
        pdf_m = mf.vndf_pdf(wi_f, m, a, a)
        cos_om = dot(wo, m_o)
        jac_r = 1.0 / torch.clamp(4.0 * torch.abs(cos_om), min=1e-20)
        denom = cos_im + eta_it * cos_om
        jac_t = torch.abs(cos_om) * torch.square(eta_it) / torch.clamp(
            torch.square(denom), min=1e-20)
        pdf = pdf_m * torch.where(pick_reflect, f * jac_r, (1.0 - f) * jac_t)

        # a reflection stays on the incident side, a refraction crosses
        # (total internal reflection has cos_t = 0 and must reflect)
        same_side = Frame.cos_theta(wo) * cos_i > 0.0
        valid_lobe = torch.where(pick_reflect, same_side,
                                 ~same_side & (cos_t != 0.0))
        ok = active & (pdf > 0.0) & valid_lobe
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0),
            eta=torch.where(pick_reflect, 1.0, eta_it),
            delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
            sampled_type=_pick_flags(pick_reflect, Flags.GlossyReflection,
                                     Flags.GlossyTransmission))
        return bs, torch.where(ok[..., None], weight, 0.0)

    def eval(self, si, wo, active):
        return self.eval_pdf(si, wo, active)[0]

    def pdf(self, si, wo, active):
        return self.eval_pdf(si, wo, active)[1]

    def eval_pdf(self, si, wo, active):
        a = self._a()
        eta = torch.as_tensor(self.eta, device=wo.device)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        reflect_cfg = cos_i * cos_o > 0.0
        eta_path = torch.where(cos_i > 0.0, eta, 1.0 / eta)
        # half vector: wi + wo for a reflection, wi + eta wo for a refraction
        m = torch.where(reflect_cfg[..., None], si.wi + wo,
                        si.wi + wo * eta_path[..., None])
        norm2 = torch.sum(m * m, dim=-1, keepdim=True)
        m = m * torch.where(norm2 > 1e-20, 1.0 / torch.sqrt(
            torch.clamp(norm2, min=1e-20)), 0.0)
        m = mulsign(m, m[..., 2:3])   # the upper hemisphere
        m_o = mulsign(m, cos_i[..., None])

        cos_im = dot(si.wi, m_o)
        cos_om = dot(wo, m_o)
        f, _, eta_it, eta_ti = fresnel_dielectric(cos_im, eta)
        wi_f = mulsign(si.wi, cos_i[..., None])
        wo_f = mulsign(wo, cos_o[..., None])
        d = mf.ggx_D(m, a, a)
        g2 = mf.smith_g1(wi_f, m, a, a) * mf.smith_g1(wo_f, m, a, a)

        val_r = f * d * g2 / torch.clamp(4.0 * torch.abs(cos_i), min=1e-20)
        denom = cos_im + eta_it * cos_om
        val_t = ((1.0 - f) * d * g2 * torch.abs(cos_im * cos_om)
                 * torch.square(eta_it)
                 / torch.clamp(torch.abs(cos_i) * torch.square(denom),
                               min=1e-20)) * torch.square(eta_ti)
        val = torch.where(reflect_cfg, val_r, torch.abs(val_t))

        pdf_m = mf.vndf_pdf(wi_f, m, a, a)
        jac_r = 1.0 / torch.clamp(4.0 * torch.abs(cos_om), min=1e-20)
        jac_t = torch.abs(cos_om) * torch.square(eta_it) / torch.clamp(
            torch.square(denom), min=1e-20)
        pdf = pdf_m * torch.where(reflect_cfg, f * jac_r, (1.0 - f) * jac_t)
        ok = active & (torch.abs(cos_i) > 1e-6) & (norm2[..., 0] > 1e-20) \
            & (reflect_cfg | (cos_im * cos_om < 0.0))
        val3 = val[..., None].expand(val.shape + (3,))
        if self.specular_reflectance is not None:
            val3 = torch.where(reflect_cfg[..., None],
                               val3 * self.specular_reflectance.eval(si), val3)
        if self.specular_transmittance is not None:
            val3 = torch.where(reflect_cfg[..., None], val3,
                               val3 * self.specular_transmittance.eval(si))
        return (torch.where(ok[..., None], val3, 0.0),
                torch.where(ok, pdf, 0.0))


def refract_about(wi, m, cos_theta_t, eta_ti):
    """Refract ``wi`` about the microfacet normal ``m`` (fresnel.h
    refract)."""
    dp = dot(wi, m, keepdim=True)
    return m * (dp * eta_ti[..., None] + cos_theta_t[..., None]) \
        - wi * eta_ti[..., None]


def fdr_fit(eta):
    """Average Fresnel reflectance of diffuse light inside a dielectric
    (fresnel.h fresnel_diffuse_reflectance polynomial fits)."""
    eta = torch.as_tensor(eta)
    lo = (-0.4399 + 0.7099 / eta - 0.3319 / eta ** 2 + 0.0636 / eta ** 3)
    hi = (-1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta)
    return torch.where(eta < 1.0, lo, hi)


def _plastic_base(b, si, f_i, f_o, cos_o):
    """The diffuse base of a plastic under its coat, f x cos: the
    reflectance with the internal-scattering correction, times the two
    Fresnel transmissions over eta^2 (plastic.cpp, roughplastic.cpp)."""
    refl = b.diffuse_reflectance.eval(si)
    fdr = fdr_fit(b.eta)
    denom = 1.0 - (refl * fdr if b.nonlinear else fdr)
    return refl / torch.clamp(denom, min=1e-6) * (
        warp.INV_PI * torch.clamp(cos_o, min=0.0)
        * (1.0 - f_i) * (1.0 - f_o) / torch.square(b.eta))[..., None]


@dataclass
class SmoothPlastic:
    """Smooth dielectric coat over a diffuse base, with the internal-
    scattering correction (src/bsdfs/plastic.cpp)."""

    diffuse_reflectance: object   # texture
    eta: torch.Tensor             # () relative IOR of the coat
    nonlinear: bool = False

    flags = Flags.DeltaReflection | Flags.DiffuseReflection

    def sample(self, si, sample1, sample2, active):
        """The coat's mirror with the Fresnel reflectance's probability,
        else the cosine-sampled base; the mirror is a Dirac lobe."""
        cos_i = Frame.cos_theta(si.wi)
        f_i = fresnel_dielectric(cos_i, self.eta)[0]
        pick_spec = sample1 < f_i
        wo = torch.where(pick_spec[..., None], reflect(si.wi),
                         warp.square_to_cosine_hemisphere(sample2))
        cos_o = Frame.cos_theta(wo)
        f_o = fresnel_dielectric(cos_o, self.eta)[0]
        refl = self.diffuse_reflectance.eval(si)
        fdr = fdr_fit(self.eta)
        denom = 1.0 - (refl * fdr if self.nonlinear else fdr)
        diff_val = refl / torch.clamp(denom, min=1e-6) * (
            (1.0 / torch.square(self.eta)) * (1.0 - f_i) * (1.0 - f_o)
        )[..., None]
        pdf_cos = warp.square_to_cosine_hemisphere_pdf(wo)
        pdf_diff = pdf_cos * (1.0 - f_i)
        pdf = torch.where(pick_spec, f_i, pdf_diff)
        w_diff = diff_val * torch.where(
            pdf_diff > 0.0, pdf_cos / torch.clamp(pdf_diff, min=1e-20),
            0.0)[..., None]
        weight = torch.where(pick_spec[..., None], 1.0, w_diff)
        ok = active & (cos_i > 0.0) & (cos_o > 0.0) & (pdf > 0.0)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
            delta=pick_spec,
            sampled_type=_pick_flags(pick_spec, Flags.DeltaReflection,
                                     Flags.DiffuseReflection))
        return bs, torch.where(ok[..., None], weight, 0.0)

    def _ok(self, si, wo, active):
        return active & (Frame.cos_theta(si.wi) > 0.0) \
            & (Frame.cos_theta(wo) > 0.0)

    def eval(self, si, wo, active):
        cos_i, cos_o = Frame.cos_theta(si.wi), Frame.cos_theta(wo)
        val = _plastic_base(self, si, fresnel_dielectric(cos_i, self.eta)[0],
                            fresnel_dielectric(cos_o, self.eta)[0], cos_o)
        return torch.where(self._ok(si, wo, active)[..., None], val, 0.0)

    def pdf(self, si, wo, active):
        f_i = fresnel_dielectric(Frame.cos_theta(si.wi), self.eta)[0]
        return torch.where(self._ok(si, wo, active),
                           warp.square_to_cosine_hemisphere_pdf(wo)
                           * (1.0 - f_i), 0.0)

    def eval_pdf(self, si, wo, active):
        return self.eval(si, wo, active), self.pdf(si, wo, active)


@dataclass
class RoughPlastic:
    """GGX rough dielectric coat over a diffuse base
    (src/bsdfs/roughplastic.cpp)."""

    diffuse_reflectance: object   # texture
    eta: torch.Tensor             # () relative IOR of the coat
    alpha: torch.Tensor           # () isotropic roughness
    nonlinear: bool = False

    flags = Flags.GlossyReflection | Flags.DiffuseReflection

    def _a(self):
        return torch.clamp(torch.as_tensor(self.alpha), min=1e-4)

    def sample(self, si, sample1, sample2, active):
        """A VNDF reflection off the coat with the Fresnel reflectance's
        probability, else the cosine-sampled base (the same sample2);
        weight = the mixture's eval over its pdf."""
        a = self._a()
        cos_i = Frame.cos_theta(si.wi)
        f_i = fresnel_dielectric(cos_i, self.eta)[0]
        pick_spec = sample1 < f_i
        m = mf.sample_vndf(si.wi, sample2, a, a)
        wo = torch.where(pick_spec[..., None],
                         2.0 * dot(si.wi, m, keepdim=True) * m - si.wi,
                         warp.square_to_cosine_hemisphere(sample2))
        val, pdf = self.eval_pdf(si, wo, active)
        ok = active & (pdf > 0.0) & (Frame.cos_theta(wo) > 0.0) \
            & (cos_i > 0.0)
        weight = torch.where(
            ok[..., None], val / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
            delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
            sampled_type=_pick_flags(pick_spec, Flags.GlossyReflection,
                                     Flags.DiffuseReflection))
        return bs, weight

    def eval(self, si, wo, active):
        return self.eval_pdf(si, wo, active)[0]

    def pdf(self, si, wo, active):
        return self.eval_pdf(si, wo, active)[1]

    def eval_pdf(self, si, wo, active):
        a = self._a()
        cos_i, cos_o = Frame.cos_theta(si.wi), Frame.cos_theta(wo)
        ok = active & (cos_i > 0.0) & (cos_o > 0.0)
        m = si.wi + wo
        m = m / torch.sqrt(torch.clamp(torch.sum(m * m, dim=-1, keepdim=True),
                                       min=1e-20))
        f_m = fresnel_dielectric(dot(si.wi, m), self.eta)[0]
        spec = f_m * mf.ggx_D(m, a, a) * mf.smith_g2(si.wi, wo, m, a, a) \
            / torch.clamp(4.0 * cos_i, min=1e-20)
        f_i = fresnel_dielectric(cos_i, self.eta)[0]
        f_o = fresnel_dielectric(cos_o, self.eta)[0]
        val = spec[..., None] + _plastic_base(self, si, f_i, f_o, cos_o)
        jac = 1.0 / torch.clamp(4.0 * torch.abs(dot(wo, m)), min=1e-20)
        pdf = (f_i * mf.vndf_pdf(si.wi, m, a, a) * jac
               + (1.0 - f_i) * warp.square_to_cosine_hemisphere_pdf(wo))
        return (torch.where(ok[..., None], val, 0.0),
                torch.where(ok, pdf, 0.0))


@dataclass
class TwoSided:
    """Two-sided adapter (src/bsdfs/twosided.cpp): a hit on the back
    evaluates the nested BSDF in the frame flipped about the surface, so
    the back scatters as the front does."""

    nested: object

    @property
    def flags(self):
        return self.nested.flags

    @staticmethod
    def _flip_z(v):
        return v * torch.tensor([1.0, 1.0, -1.0], device=v.device)

    def _flip(self, si):
        si_b = copy.copy(si)
        si_b.wi = self._flip_z(si.wi)
        return si_b

    def sample(self, si, sample1, sample2, active):
        back = Frame.cos_theta(si.wi) < 0.0
        bs_f, w_f = self.nested.sample(si, sample1, sample2, active & ~back)
        bs_b, w_b = self.nested.sample(self._flip(si), sample1, sample2,
                                       active & back)
        bs_b.wo = self._flip_z(bs_b.wo)
        return (select(back, bs_b, bs_f),
                torch.where(back[..., None], w_b, w_f))

    def eval(self, si, wo, active):
        return self.eval_pdf(si, wo, active)[0]

    def pdf(self, si, wo, active):
        return self.eval_pdf(si, wo, active)[1]

    def eval_pdf(self, si, wo, active):
        back = Frame.cos_theta(si.wi) < 0.0
        v_f, p_f = self.nested.eval_pdf(si, wo, active & ~back)
        v_b, p_b = self.nested.eval_pdf(self._flip(si), self._flip_z(wo),
                                        active & back)
        return (torch.where(back[..., None], v_b, v_f),
                torch.where(back, p_b, p_f))
