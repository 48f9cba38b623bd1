"""Spectral support for the hero-wavelength particle tracer
(mitsuba_tpu/core/spectrum.py; reference include/mitsuba/core/spectrum.h).

A spectral lane carries one wavelength (``Ray.wavelengths``, (N, 1) nm).
A dispersive BSDF evaluates its IOR there; the path's RGB throughput is
weighted by ``rgb_response_flat(lambda) / pdf(lambda)``, the CIE 1931
response in linear sRGB normalised so that a spectrally flat radiance
integrates to (1, 1, 1).  The CIE 1931 2-degree observer at 5 nm,
380-780 nm, with linear interpolation between the nodes; the tables are
the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

LAMBDA_MIN = 380.0
LAMBDA_MAX = 780.0

# CIE 1931 2-degree observer, 380:5:780 nm (81 samples per channel).
_CIE_X = np.array([
    0.001368, 0.002236, 0.004243, 0.007650, 0.014310, 0.023190, 0.043510,
    0.077630, 0.134380, 0.214770, 0.283900, 0.328500, 0.348280, 0.348060,
    0.336200, 0.318700, 0.290800, 0.251100, 0.195360, 0.142100, 0.095640,
    0.057950, 0.032010, 0.014700, 0.004900, 0.002400, 0.009300, 0.029100,
    0.063270, 0.109600, 0.165500, 0.225750, 0.290400, 0.359700, 0.433450,
    0.512050, 0.594500, 0.678400, 0.762100, 0.842500, 0.916300, 0.978600,
    1.026300, 1.056700, 1.062200, 1.045600, 1.002600, 0.938400, 0.854450,
    0.751400, 0.642400, 0.541900, 0.447900, 0.360800, 0.283500, 0.218700,
    0.164900, 0.121200, 0.087400, 0.063600, 0.046770, 0.032900, 0.022700,
    0.015840, 0.011359, 0.008111, 0.005790, 0.004109, 0.002899, 0.002049,
    0.001440, 0.001000, 0.000690, 0.000476, 0.000332, 0.000235, 0.000166,
    0.000117, 0.000083, 0.000059, 0.000042,
], np.float32)
_CIE_Y = np.array([
    0.000039, 0.000064, 0.000120, 0.000217, 0.000396, 0.000640, 0.001210,
    0.002180, 0.004000, 0.007300, 0.011600, 0.016840, 0.023000, 0.029800,
    0.038000, 0.048000, 0.060000, 0.073900, 0.090980, 0.112600, 0.139020,
    0.169300, 0.208020, 0.258600, 0.323000, 0.407300, 0.503000, 0.608200,
    0.710000, 0.793200, 0.862000, 0.914850, 0.954000, 0.980300, 0.994950,
    1.000000, 0.995000, 0.978600, 0.952000, 0.915400, 0.870000, 0.816300,
    0.757000, 0.694900, 0.631000, 0.566800, 0.503000, 0.441200, 0.381000,
    0.321000, 0.265000, 0.217000, 0.175000, 0.138200, 0.107000, 0.081600,
    0.061000, 0.044580, 0.032000, 0.023200, 0.017000, 0.011920, 0.008210,
    0.005723, 0.004102, 0.002929, 0.002091, 0.001484, 0.001047, 0.000740,
    0.000520, 0.000361, 0.000249, 0.000172, 0.000120, 0.000085, 0.000060,
    0.000042, 0.000030, 0.000021, 0.000015,
], np.float32)
_CIE_Z = np.array([
    0.006450, 0.010550, 0.020050, 0.036210, 0.067850, 0.110200, 0.207400,
    0.371300, 0.645600, 1.039050, 1.385600, 1.622960, 1.747060, 1.782600,
    1.772110, 1.744100, 1.669200, 1.528100, 1.287640, 1.041900, 0.812950,
    0.616200, 0.465180, 0.353300, 0.272000, 0.212300, 0.158200, 0.111700,
    0.078250, 0.057250, 0.042160, 0.029840, 0.020300, 0.013400, 0.008750,
    0.005750, 0.003900, 0.002750, 0.002100, 0.001800, 0.001650, 0.001400,
    0.001100, 0.001000, 0.000800, 0.000600, 0.000340, 0.000240, 0.000190,
    0.000100, 0.000050, 0.000030, 0.000020, 0.000010, 0.000000, 0.000000,
    0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
    0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
    0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
    0.000000, 0.000000, 0.000000, 0.000000,
], np.float32)

# normalization: integral of y_bar over the range (in nm units)
_CIE_Y_INTEGRAL = float(np.trapezoid(_CIE_Y, dx=5.0))

# linear sRGB (D65) <- XYZ
XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
], np.float32)
_CIE = np.stack([_CIE_X, _CIE_Y, _CIE_Z], axis=-1)   # (81, 3)


def cie1931_xyz(wavelength_nm):
    """Interpolated (x_bar, y_bar, z_bar) at wavelengths in nm, (..., 3);
    zero outside [380, 780]."""
    lam = wavelength_nm
    tbl = torch.as_tensor(_CIE, device=lam.device)
    t = (lam - LAMBDA_MIN) / 5.0
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, 79)
    f = torch.clamp(t - i, 0.0, 1.0)[..., None]
    v = tbl[i] * (1.0 - f) + tbl[i + 1] * f
    inside = ((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX))[..., None]
    return torch.where(inside, v, 0.0)


def rgb_response(wavelength_nm):
    """Linear-sRGB response of radiance at one wavelength: integrating
    L(lambda) * rgb_response over lambda gives the sRGB tristimulus of the
    spectrum, normalised by the Y integral.  Multiplies and adds in the
    JAX package's order."""
    xyz = cie1931_xyz(wavelength_nm)
    m = torch.as_tensor(XYZ_TO_SRGB, device=xyz.device)
    rgb = (xyz[..., 0:1] * m[:, 0] + xyz[..., 1:2] * m[:, 1]
           + xyz[..., 2:3] * m[:, 2])
    return rgb / _CIE_Y_INTEGRAL


def _e_white():
    """sRGB of the equal-energy illuminant, the per-channel integral of
    ``rgb_response`` at 1 nm (trapezoids in float32, as the JAX package
    computes it on the host)."""
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1e-3, 1.0, np.float32)
    resp = rgb_response(torch.from_numpy(lam)).numpy()
    return np.trapezoid(resp, lam, axis=0).astype(np.float32)


_E_WHITE = _e_white()


def rgb_response_flat(wavelength_nm):
    """``rgb_response`` normalised per channel so that a spectrally flat
    radiance integrates to (1, 1, 1): the response of hero-wavelength
    estimators."""
    return rgb_response(wavelength_nm) / torch.as_tensor(
        _E_WHITE, device=wavelength_nm.device)


def sample_wavelength_visible(u):
    """Importance sampling of the visible range (spectrum.h
    sample_rgb_spectrum, Radziszewski et al.): pdf proportional to sech^2
    centred at 538 nm.  Returns (lambda, pdf), lambda clamped to
    [380, 780]."""
    lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)
    pdf = 0.0039398042 / torch.square(torch.cosh(0.0072 * (lam - 538.0)))
    return torch.clamp(lam, LAMBDA_MIN, LAMBDA_MAX), pdf
