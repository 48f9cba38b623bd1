"""Optimizable lens surfaces: their sag functions
(mitsuba_tpu/lens/surfaces.py; reference lens_design/lens.py:26-250 of
the fork).

The curvature is stored dimensionless, c * radial_extent, so that an
optimizer step is scale-free (lens.py:55-63).  Sag convention
(lens.py:70-85): z(r) = z0 - R * sag(r / R) with the film at z = 0 and +z
toward object space; a surface of positive c bulges toward -z.  Every
parameter is a float32 tensor that may require grad.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..device import resolve_device


def as_param(x, device=None):
    """``x`` as a float32 tensor: a tensor keeps its graph (and device); a
    number is copied to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _conic(surface, x, y):
    """(r^2 / R^2, the conic term r2 c / (1 + sqrt(1 - (1 + K) c^2 r2)))."""
    r2 = (torch.square(x) + torch.square(y)) / surface.radial_extent ** 2
    safe = torch.clamp(1.0 - (1.0 + surface.K) * torch.square(surface.c) * r2,
                       min=1e-12)
    return r2, r2 * surface.c / (1.0 + torch.sqrt(safe))


@dataclass
class ConicSurface:
    radial_extent: float     # R, mm
    c: torch.Tensor          # () dimensionless curvature, c_dim * R
    K: torch.Tensor          # () conic constant
    z0: torch.Tensor         # () axial position

    PARAMS = ("c", "K", "z0")

    @staticmethod
    def create(radial_extent, c, K, z0, device=None):
        """``c`` is the dimensional curvature, 1/mm (lens.py:56 scales it);
        the tensors live on ``device`` (default: the GPU)."""
        device = resolve_device(device)
        return ConicSurface(radial_extent=float(radial_extent),
                            c=as_param(c * radial_extent, device),
                            K=as_param(K, device), z0=as_param(z0, device))

    @property
    def params(self):
        return {k: getattr(self, k) for k in self.PARAMS}

    def with_params(self, p):
        return dataclasses.replace(self, **{
            k: as_param(v, self.z0.device) for k, v in p.items()
            if k in self.PARAMS})

    def curvature(self):
        """Dimensional curvature, 1/mm."""
        return self.c / self.radial_extent

    def sag(self, x, y):
        """z at (x, y) in camera coordinates (lens.py:70-85 compute_z_dr)."""
        _, conic = _conic(self, x, y)
        return self.z0 - self.radial_extent * conic


@dataclass
class EvenAsphericSurface:
    radial_extent: float
    c: torch.Tensor          # () dimensionless curvature
    K: torch.Tensor
    z0: torch.Tensor
    ai: torch.Tensor         # (7,) dimensionless a4 .. a16

    PARAMS = ("c", "K", "z0", "ai")

    @staticmethod
    def create(radial_extent, c, K, z0, a4=0.0, a6=0.0, a8=0.0, a10=0.0,
               a12=0.0, a14=0.0, a16=0.0, device=None):
        """Coefficients in dimensional units (mm^-(2i+3)), stored
        dimensionless against the radial extent (lens.py:166-215)."""
        device = resolve_device(device)
        R = float(radial_extent)
        a_dim = [a4, a6, a8, a10, a12, a14, a16]
        ai = torch.tensor([a * R ** (2 * i + 3) for i, a in enumerate(a_dim)],
                          dtype=torch.float32, device=device)
        return EvenAsphericSurface(radial_extent=R, c=as_param(c * R, device),
                                   K=as_param(K, device),
                                   z0=as_param(z0, device), ai=ai)

    params = ConicSurface.params
    with_params = ConicSurface.with_params
    curvature = ConicSurface.curvature

    def sag(self, x, y):
        r2, conic = _conic(self, x, y)
        poly = torch.zeros_like(r2)
        for i in range(self.ai.shape[0] - 1, -1, -1):
            poly = poly * r2 + self.ai[i]
        return self.z0 - self.radial_extent * (conic + poly * r2 ** 2)
