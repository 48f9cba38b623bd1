"""Spectrum plugins, as far as the scene loader takes them
(mitsuba_tpu/models/spectra.py; reference src/spectra/{regular,irregular,
d65,blackbody}.cpp).

Each has ``eval(lambda_nm)`` and ``to_rgb()``: the (3,) linear-sRGB value
an RGB scene stores, the spectrum integrated against the CIE response
(``core/spectrum.py::rgb_response``) by the midpoint rule on 81 nodes over
the visible range, as the JAX package does.  The spectral uses of these
classes (emitters and BSDFs evaluated per hero wavelength) wait for
ROADMAP.md Queue 1 item 6.  Host-side float32 tensors on the CPU; the
loader copies ``to_rgb()`` to the scene's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.spectrum import LAMBDA_MAX, LAMBDA_MIN, rgb_response

_GRID = torch.linspace(LAMBDA_MIN, LAMBDA_MAX, 81)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _response_rgb(eval_fn):
    """eval(lambda) * rgb_response summed over the 81-node grid, times its
    spacing."""
    vals = eval_fn(_GRID)
    dl = (LAMBDA_MAX - LAMBDA_MIN) / (_GRID.shape[0] - 1)
    return torch.sum(vals[:, None] * rgb_response(_GRID), dim=0) * dl


def _lerp_table(tab, lo, hi, lam):
    """Linear interpolation of ``tab``, evenly spaced over [lo, hi], 0
    outside it."""
    n = tab.shape[0]
    t = (lam - lo) / (hi - lo) * (n - 1)
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    f = torch.clamp(t - i, 0.0, 1.0)
    v = tab[i] * (1 - f) + tab[i + 1] * f
    return torch.where((lam >= lo) & (lam <= hi), v, 0.0)


@dataclass
class RegularSpectrum:
    """Uniformly spaced samples over [lambda_min, lambda_max], linearly
    interpolated (src/spectra/regular.cpp)."""

    values: torch.Tensor        # (N,)
    lambda_min: float = LAMBDA_MIN
    lambda_max: float = LAMBDA_MAX

    def eval(self, lam_nm):
        return _lerp_table(self.values, self.lambda_min, self.lambda_max,
                           lam_nm)

    def to_rgb(self):
        return _response_rgb(self.eval)


@dataclass
class IrregularSpectrum:
    """Samples at sorted wavelengths, linearly interpolated
    (src/spectra/irregular.cpp)."""

    wavelengths: torch.Tensor   # (N,) nm, sorted
    values: torch.Tensor        # (N,)

    def eval(self, lam_nm):
        wl = self.wavelengths
        i = torch.clamp(torch.searchsorted(wl, lam_nm, right=True) - 1, 0,
                        wl.shape[0] - 2)
        x0, x1 = wl[i], wl[i + 1]
        f = torch.clamp((lam_nm - x0) / torch.clamp(x1 - x0, min=1e-9),
                        0.0, 1.0)
        v = self.values[i] * (1 - f) + self.values[i + 1] * f
        return torch.where((lam_nm >= wl[0]) & (lam_nm <= wl[-1]), v, 0.0)

    def to_rgb(self):
        return _response_rgb(self.eval)


# CIE standard illuminant D65, 300-780 nm at 5 nm (relative SPD,
# normalised to 100 at 560 nm; the public CIE table, as the JAX package
# holds it)
_D65 = np.array([
    0.0341, 1.6643, 3.2945, 11.7652, 20.236, 28.6447, 37.0535, 38.5011,
    39.9488, 42.4302, 44.9117, 45.775, 46.6383, 49.3637, 52.0891, 51.0323,
    49.9755, 52.3118, 54.6482, 68.7015, 82.7549, 87.1204, 91.486, 92.4589,
    93.4318, 90.057, 86.6823, 95.7736, 104.865, 110.936, 117.008, 117.41,
    117.812, 116.336, 114.861, 115.392, 115.923, 112.367, 108.811, 109.082,
    109.354, 108.578, 107.802, 106.296, 104.79, 106.239, 107.689, 106.047,
    104.405, 104.225, 104.046, 102.023, 100.0, 98.1671, 96.3342, 96.0611,
    95.788, 92.2368, 88.6856, 89.3459, 90.0062, 89.8026, 89.5991, 88.6489,
    87.6987, 85.4936, 83.2886, 83.4939, 83.6992, 81.863, 80.0268, 80.1207,
    80.2146, 81.2462, 82.2778, 80.281, 78.2842, 74.0027, 69.7213, 70.6652,
    71.6091, 72.979, 74.349, 67.9765, 61.604, 65.7448, 69.8856, 72.4863,
    75.087, 69.3398, 63.5927, 55.0054, 46.4182, 56.6118, 66.8054, 65.0941,
    63.3828,
], np.float32)
_D65_L0, _D65_L1 = 300.0, 780.0


@dataclass
class D65Spectrum:
    """CIE D65 daylight (src/spectra/d65.cpp): ``scale`` times the SPD
    normalised to 1 at 560 nm."""

    scale: torch.Tensor = None   # ()

    def __post_init__(self):
        if self.scale is None:
            self.scale = torch.tensor(1.0)

    def eval(self, lam_nm):
        return self.scale * _lerp_table(torch.from_numpy(_D65 / 100.0),
                                        _D65_L0, _D65_L1, lam_nm)

    def to_rgb(self):
        return _response_rgb(self.eval)


@dataclass
class BlackbodySpectrum:
    """Planck radiator at ``temperature`` K (src/spectra/blackbody.cpp), in
    W / (m^2 sr nm) scaled by 1e-9 as the JAX package's."""

    temperature: torch.Tensor    # ()

    def eval(self, lam_nm):
        lam_m = lam_nm * 1e-9
        h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
        num = 2.0 * h * c * c / torch.clamp(lam_m ** 5, min=1e-45)
        expo = h * c / (lam_m * kb * torch.clamp(self.temperature, min=1.0))
        return num / torch.expm1(torch.clamp(expo, 1e-6, 80.0)) * 1e-9

    def to_rgb(self):
        return _response_rgb(self.eval)


def spectrum_rgb(d):
    """The (3,) float32 numpy RGB of a loader's spectrum dict of type
    "d65", "blackbody", "regular" or "irregular" (utils/load.py
    ``_spectrum`` of the JAX package)."""
    t = d["type"]
    if t == "d65":
        s = D65Spectrum(scale=torch.tensor(float(d.get("scale", 1.0))))
    elif t == "blackbody":
        s = BlackbodySpectrum(temperature=torch.tensor(float(d.get(
            "temperature", 6500.0))))
    elif t == "regular":
        s = RegularSpectrum(values=_f32(d["values"]),
                            lambda_min=float(d.get("lambda_min", 380.0)),
                            lambda_max=float(d.get("lambda_max", 780.0)))
    elif t == "irregular":
        s = IrregularSpectrum(wavelengths=_f32(d["wavelengths"]),
                              values=_f32(d["values"]))
    else:
        raise ValueError(f"unsupported spectrum type {t!r}")
    return s.to_rgb().numpy().astype(np.float32)
