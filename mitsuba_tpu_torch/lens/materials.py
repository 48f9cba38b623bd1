"""Dispersive optical glasses of the realistic-lens camera
(mitsuba_tpu/lens/materials.py; reference src/sensors/realisticlens.cpp:
148-241, DispersiveMaterial).

The Cauchy model n(lambda) = A + B / lambda^2 or the 3-term Sellmeier
n^2 = 1 + sum Bi lambda^2 / (lambda^2 - Ci), wavelengths in micrometres.
A and B are differentiable leaves.  This is the camera's glass; the lens
design path's ``LensMaterial`` (n_d, V_d) is another class, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

NOMINAL_WAVELENGTH_UM = 0.5893  # sodium d-line; realisticlens.cpp:176


def _f32(x, device=None):
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclass
class DispersiveMaterial:
    cauchy: torch.Tensor       # (2,) A, B (Cauchy mode)
    sellmeier_B: torch.Tensor  # (3,)
    sellmeier_C: torch.Tensor  # (3,)
    use_cauchy: bool = True
    name: str = ""

    @staticmethod
    def cauchy_material(name, A, B, device=None):
        return DispersiveMaterial(
            cauchy=_f32([A, B], device), sellmeier_B=_f32([0.0] * 3, device),
            sellmeier_C=_f32([0.0] * 3, device), use_cauchy=True, name=name)

    @staticmethod
    def sellmeier_material(name, B, C, device=None):
        return DispersiveMaterial(
            cauchy=_f32([0.0, 0.0], device), sellmeier_B=_f32(B, device),
            sellmeier_C=_f32(C, device), use_cauchy=False, name=name)

    def copy_to(self, device):
        """The same glass with tensors of its own on ``device``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).detach().to(device).clone()
            for k in ("cauchy", "sellmeier_B", "sellmeier_C")})

    def ior(self, wavelength_um):
        """The IOR at wavelengths in micrometres (realisticlens.cpp:183)."""
        lam2 = torch.square(wavelength_um)
        if self.use_cauchy:
            return self.cauchy[0] + self.cauchy[1] / lam2
        n2 = 1.0
        for i in range(3):
            n2 = n2 + self.sellmeier_B[i] * lam2 / (lam2 - self.sellmeier_C[i])
        return torch.sqrt(n2)

    def ior_from_ray(self, ray):
        """The IOR at the ray's hero wavelength (nm), or at the nominal
        589.3 nm on an RGB ray (``wavelengths`` None;
        realisticlens.cpp:169-180)."""
        if ray.wavelengths is None:
            lam = torch.full(ray.o.shape[:-1], NOMINAL_WAVELENGTH_UM,
                             device=ray.o.device)
        else:
            lam = 0.001 * ray.wavelengths[..., 0]
        return self.ior(lam)

    def abbe_number(self):
        dev = self.cauchy.device
        nd = self.ior(_f32(0.58756, dev))
        nf = self.ior(_f32(0.4861, dev))
        nc = self.ior(_f32(0.6563, dev))
        return (nd - 1.0) / (nf - nc)


AIR = DispersiveMaterial.cauchy_material("Air", 1.000277, 0.0)
NBK7 = DispersiveMaterial.cauchy_material("NBK7", 1.5046, 0.00420)
