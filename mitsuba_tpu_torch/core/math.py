"""Small vector-math helpers over (..., 3) float32 tensors
(mitsuba_tpu/core/math.py)."""
from __future__ import annotations

import torch

RAY_EPS = 1e-4  # spawn-ray offset scale (reference: math::RayEpsilon)


def dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def rsqrt_safe(x, eps=1e-20):
    return torch.where(x > eps, torch.reciprocal(torch.sqrt(torch.clamp(x, min=eps))), 0.0)


def normalize(v):
    return v * rsqrt_safe(dot(v, v, keepdim=True))


def safe_sqrt(x):
    """sqrt clamped at 0."""
    return torch.where(x > 0.0, torch.sqrt(torch.clamp(x, min=0.0)), 0.0)


def safe_div(a, b, eps=1e-20):
    """a / b, 0 where |b| <= eps."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def safe_rcp(x, eps=1e-20):
    """Reciprocal that maps (+/-)0 -> (+/-)1e30 (ray inverse directions)."""
    ok = torch.abs(x) > eps
    big = torch.where(torch.signbit(x), -1e30, 1e30)
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), big)


def coordinate_system(n):
    """Orthonormal basis (s, t) around unit normal n (Duff et al. 2017)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return s, t


class Frame:
    """Shading frame (s, t, n) around a unit normal (frame.h): local <->
    world conversion as pure functions of the tuple."""

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return s, t, n

    @staticmethod
    def to_local(frame, v):
        s, t, n = frame
        return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)

    @staticmethod
    def to_world(frame, v):
        s, t, n = frame
        return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]

    @staticmethod
    def cos_theta(v):
        return v[..., 2]
