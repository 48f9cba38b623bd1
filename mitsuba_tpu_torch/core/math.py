"""Small vector-math helpers over (..., 3) float32 tensors
(mitsuba_tpu/core/math.py).

``dot`` and ``via_f64`` give the same bits on the CPU and the GPU (a
``torch.sum`` over the last dimension does not; ``torch.linalg.cross``
does), so that a path traced on either device hits nearly the same
points: a texel's gradient moves by 1e-3 of its norm when the rays move
by an ulp (a 512 x 512 texture on a wall seen from 4 units away)."""
from __future__ import annotations

import torch

RAY_EPS = 1e-4  # spawn-ray offset scale (reference: math::RayEpsilon)


def dot(a, b, keepdim=False):
    """The sum of the products over the last dimension, added first to
    last: the CPU reduction's order, made explicit for every device."""
    p = a * b
    s = p[..., 0]
    for i in range(1, p.shape[-1]):
        s = s + p[..., i]
    return s[..., None] if keepdim else s


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def via_f64(fn, x):
    """``fn`` of a float32 tensor computed in float64 and rounded: the
    correctly rounded value (but in rare halfway cases), the same on every
    device, where float32 sin, cos, tan differ by an ulp between them."""
    return fn(x.double()).to(x.dtype)


def sqrt(x):
    """The correctly rounded square root on every device.  The card's
    float32 sqrt is; the CPU's vectorised one is an ulp off on about 0.7 %
    of inputs, and a camera ray an ulp apart sends a path elsewhere, so a
    CPU tensor's float32 root is taken in float64 and rounded once."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def rsqrt_safe(x, eps=1e-20):
    return torch.where(x > eps, torch.reciprocal(sqrt(torch.clamp(x, min=eps))), 0.0)


def normalize(v):
    return v * rsqrt_safe(dot(v, v, keepdim=True))


def safe_sqrt(x):
    """sqrt clamped at 0, its gradient 0 where x <= 0 (the double where:
    a clamp alone lets 0 * inf = NaN through at x = 0)."""
    ok = x > 0.0
    return torch.where(ok, sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_div(a, b, eps=1e-20):
    """a / b, 0 where |b| <= eps."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def safe_rcp(x, eps=1e-20):
    """Reciprocal that maps (+/-)0 -> (+/-)1e30 (ray inverse directions)."""
    ok = torch.abs(x) > eps
    big = torch.where(torch.signbit(x), -1e30, 1e30)
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), big)


def sqr(x):
    return x * x


def reflect(wi):
    """Mirror direction in the local frame: (-x, -y, z)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def mulsign(a, b):
    """a where b >= 0, else -a."""
    return torch.where(b >= 0.0, a, -a)


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
