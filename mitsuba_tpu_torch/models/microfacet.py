"""GGX microfacet distribution (mitsuba_tpu/models/microfacet.py;
reference include/mitsuba/render/microfacet.h): Smith separable
shadowing and Heitz 2018 visible-normal (VNDF) sampling over local-frame
directions (..., 3)."""
from __future__ import annotations

import math

import torch

from ..core.math import cross, normalize, safe_div, safe_sqrt, sqr


def ggx_D(m, ax, ay):
    """GGX normal distribution function (anisotropic)."""
    c2 = sqr(m[..., 2])
    t = sqr(m[..., 0] / ax) + sqr(m[..., 1] / ay) + c2
    d = safe_div(torch.ones_like(t), math.pi * ax * ay * sqr(t))
    return torch.where(m[..., 2] > 0.0, d, 0.0)


def ggx_lambda(v, ax, ay):
    """Smith Lambda for GGX."""
    c2 = sqr(v[..., 2])
    a2 = sqr(v[..., 0] * ax) + sqr(v[..., 1] * ay)
    return 0.5 * (safe_sqrt(1.0 + safe_div(a2, c2)) - 1.0)


def smith_g1(v, m, ax, ay):
    """Masking function; zero when v is on the wrong side of m."""
    g = 1.0 / (1.0 + ggx_lambda(v, ax, ay))
    backfacing = (torch.sum(v * m, dim=-1) * v[..., 2]) <= 0.0
    return torch.where(backfacing, 0.0, g)


def smith_g2(wi, wo, m, ax, ay):
    """Separable Smith shadowing-masking."""
    return smith_g1(wi, m, ax, ay) * smith_g1(wo, m, ax, ay)


def sample_vndf(wi, sample2, ax, ay):
    """A visible normal (Heitz 2018, "Sampling the GGX Distribution of
    Visible Normals") for ``wi`` in the upper hemisphere."""
    vh = normalize(torch.stack([ax * wi[..., 0], ay * wi[..., 1], wi[..., 2]],
                               dim=-1))
    lensq = sqr(vh[..., 0]) + sqr(vh[..., 1])
    inv = safe_div(torch.ones_like(lensq), safe_sqrt(lensq))
    t1 = torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                      torch.zeros_like(inv)], dim=-1)
    t1 = torch.where((lensq > 1e-12)[..., None], t1,
                     torch.tensor([1.0, 0.0, 0.0], device=t1.device))
    t2 = cross(vh, t1)
    r = safe_sqrt(sample2[..., 0])
    phi = 2.0 * math.pi * sample2[..., 1]
    p1 = r * torch.cos(phi.double()).to(phi.dtype)
    p2 = r * torch.sin(phi.double()).to(phi.dtype)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - sqr(p1)) + s * p2
    p3 = safe_sqrt(torch.clamp(1.0 - sqr(p1) - sqr(p2), min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=1e-6)], dim=-1))


def vndf_pdf(wi, m, ax, ay):
    """pdf of ``sample_vndf`` in the half-vector measure."""
    return safe_div(smith_g1(wi, m, ax, ay)
                    * torch.abs(torch.sum(wi * m, dim=-1)) * ggx_D(m, ax, ay),
                    torch.abs(wi[..., 2]))
