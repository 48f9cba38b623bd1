"""Warps from [0,1)^2 to canonical domains (mitsuba_tpu/core/warp.py)."""
from __future__ import annotations

import math

import torch

from .math import safe_sqrt

INV_PI = 1.0 / math.pi


def square_to_uniform_disk_concentric(s):
    """Shirley-Chiu concentric mapping, (..., 2) -> (..., 2)."""
    x = 2.0 * s[..., 0] - 1.0
    y = 2.0 * s[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quad_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quad_x, x, y)
    ratio = torch.where(
        quad_x,
        torch.where(x != 0.0, y / torch.where(x != 0.0, x, 1.0), 0.0),
        torch.where(y != 0.0, x / torch.where(y != 0.0, y, 1.0), 0.0),
    )
    phi = torch.where(quad_x, (math.pi / 4.0) * ratio,
                      (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    r = torch.where(is_zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(s):
    """Cosine-weighted hemisphere via the concentric disk, (..., 2) -> (..., 3)."""
    p = square_to_uniform_disk_concentric(s)
    z = safe_sqrt(1.0 - torch.sum(p * p, dim=-1))
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(s):
    """Uniform barycentrics over the unit triangle (b0 + b1 <= 1)."""
    t = safe_sqrt(1.0 - s[..., 0])
    return torch.stack([1.0 - t, t * s[..., 1]], dim=-1)
