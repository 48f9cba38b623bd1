"""Fresnel equations (mitsuba_tpu/core/fresnel.py; reference
include/mitsuba/render/fresnel.h), used by the conductor and dielectric
BSDFs and the lens camera's interfaces."""
from __future__ import annotations

import torch

from .math import dot, safe_sqrt, sqr


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance at a dielectric interface.

    ``cos_theta_i`` is signed (positive: the ray arrives from the
    exterior, where ``eta`` = int_ior / ext_ior).  Returns (F,
    cos_theta_t, eta_it, eta_ti): the reflectance in [0, 1], the signed
    cosine of the transmitted ray (0 on total internal reflection), the
    relative IOR along the transmission and its reciprocal."""
    eta = torch.as_tensor(eta, dtype=cos_theta_i.dtype,
                          device=cos_theta_i.device)
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)

    cti = torch.abs(cos_theta_i)
    sin2_t = sqr(eta_ti) * torch.clamp(1.0 - sqr(cti), min=0.0)
    tir = sin2_t >= 1.0
    ctt = safe_sqrt(1.0 - sin2_t)

    rs = (cti - eta_it * ctt) / torch.clamp(cti + eta_it * ctt, min=1e-20)
    rp = (eta_it * cti - ctt) / torch.clamp(eta_it * cti + ctt, min=1e-20)
    f = 0.5 * (sqr(rs) + sqr(rp))
    f = torch.where(tir, 1.0, f)
    # index matched: no reflection
    f = torch.where(torch.abs(eta - 1.0) < 1e-6, 0.0, f)
    cos_theta_t = torch.where(tir, 0.0, -torch.sign(cos_theta_i) * ctt)
    return f, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized conductor Fresnel with the complex IOR eta + i k;
    ``eta`` and ``k`` broadcast against ``cos_theta_i[..., None]`` (one
    IOR a channel)."""
    c2 = sqr(cos_theta_i)[..., None]
    s2 = 1.0 - c2
    e2 = sqr(eta)
    k2 = sqr(k)
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(sqr(t0) + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * torch.abs(cos_theta_i)[..., None]
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2b2 + sqr(s2)
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def refract(wi, cos_theta_t, eta_ti):
    """Refract the local-frame ``wi`` given ``cos_theta_t`` of
    ``fresnel_dielectric`` (valid where cos_theta_t != 0)."""
    scale = -eta_ti
    return torch.stack([scale * wi[..., 0], scale * wi[..., 1],
                        cos_theta_t * torch.ones_like(wi[..., 2])], dim=-1)


def refract_n(wi, n, cos_theta_t, eta_ti):
    """Refract ``wi`` (pointing away from the surface, toward the source)
    about the world-frame unit normal ``n``."""
    dp = dot(wi, n, keepdim=True)
    return (n * (dp * eta_ti[..., None] + cos_theta_t[..., None])
            - wi * eta_ti[..., None])
