"""Emitters (mitsuba_tpu/models/emitters.py): the area light only.

A geometry-bound emitter receives its mesh through ``geom = (mesh,
face_distr)``, owned by the Scene.  The megakernels (ops/megakernel.py)
carry the same light in their packed light table.  The JAX package's
analytic-sphere branch is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.math import Frame, dot, safe_div
from ..core.records import DirectionSample


@dataclass
class AreaEmitter:
    """Diffuse area light attached to a shape (src/emitters/area.cpp)."""

    radiance: object              # texture
    sampling_weight: float = 1.0  # relative emitter selection probability

    def eval(self, si, active):
        """Radiance toward ``si.wi``: the front side emits."""
        front = Frame.cos_theta(si.wi) > 0.0
        return torch.where((active & front)[..., None],
                           self.radiance.eval(si), 0.0)

    def sample_direction(self, ref_p, sample1, sample2, geom):
        """NEE sample toward the light from ``ref_p``: (DirectionSample,
        Le / pdf), solid-angle measure."""
        mesh, face_distr = geom
        ps = mesh.sample_position(sample1, sample2, face_distr)
        delta = ps.p - ref_p
        dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-12)
        dist = torch.sqrt(dist2)
        d = delta / dist[..., None]
        cos_emitter = -dot(d, ps.n)
        pdf = torch.where(cos_emitter > 1e-6,
                          ps.pdf * dist2 / torch.clamp(cos_emitter, min=1e-6),
                          0.0)
        weight = torch.where((pdf > 0.0)[..., None],
                             self.radiance.eval(ps)
                             / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        zero = torch.zeros(pdf.shape, dtype=torch.int64, device=pdf.device)
        return DirectionSample(p=ps.p, n=ps.n, uv=ps.uv, d=d, dist=dist,
                               pdf=pdf, delta=zero.bool(),
                               emitter_index=zero), weight

    def pdf_direction(self, ref_p, ds, geom):
        """Solid-angle pdf of ``sample_direction`` having produced ``ds``."""
        mesh, _ = geom
        cos_emitter = -dot(ds.d, ds.n)
        area_pdf = safe_div(1.0, mesh.surface_area())
        return torch.where(
            cos_emitter > 1e-6,
            area_pdf * ds.dist ** 2 / torch.clamp(cos_emitter, min=1e-6), 0.0)
