"""BSDFs (mitsuba_tpu/models/bsdfs.py): the Lambertian BSDF only.

All directions are in the local shading frame (z = normal) and ``si.wi``
points away from the surface.  ``eval`` returns f * |cos_theta_o|,
``sample`` returns (BSDFSample, eval / pdf), as in the reference.  The
megakernels (ops/megakernel.py) carry the same lobe in their own body.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.math import Frame
from ..core.records import BSDFSample

DIFFUSE_REFLECTION = 1   # BSDFFlags::DiffuseReflection (bsdf.h:13)


@dataclass
class SmoothDiffuse:
    """Lambertian reflection (src/bsdfs/diffuse.cpp)."""

    reflectance: object   # texture

    def sample(self, si, sample1, sample2, active):
        cos_i = Frame.cos_theta(si.wi)
        wo = warp.square_to_cosine_hemisphere(sample2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        ok = active & (cos_i > 0.0) & (pdf > 0.0)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
            delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
            sampled_type=torch.full(pdf.shape, DIFFUSE_REFLECTION,
                                    device=pdf.device))
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
