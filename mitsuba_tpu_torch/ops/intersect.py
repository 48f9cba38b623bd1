"""Ray-triangle tests (mitsuba_tpu/ops/intersect.py).

- ``tri_test``/``tri_test_uv``: Moller-Trumbore on broadcastable
  components, in the kernels' order of operations (csrc/path_common.cuh
  ``tri_test``); the plain versions of every kernel share them.
- ``ray_triangle``: the JAX package's ``ray_triangle`` on (..., 3)
  vectors, with ``safe_div``; ``Scene.compute_si`` re-derives the hit
  with it.
"""
from __future__ import annotations

import torch

from ..core.math import dot, safe_div
from ..core.math import cross as vcross

DET_EPS = 1e-9


def cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def tri_test_uv(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z,
                ox, oy, oz, dx, dy, dz, maxt):
    """Moller-Trumbore on broadcastable components: the triangle's
    (p0, e1, e2) may be Python floats or tensors.  Returns (hit, t, u, v)
    where ``hit`` includes ``0 < t <= maxt``."""
    pvx, pvy, pvz = cross(dx, dy, dz, e2x, e2y, e2z)
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx, qvy, qvz = cross(tvx, tvy, tvz, e1x, e1y, e1z)
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = (ok & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0)
           & (t > 0.0) & (t <= maxt))
    return hit, t, u, vv


def tri_test(*args):
    """``tri_test_uv`` without the barycentrics: (hit, t)."""
    hit, t, _, _ = tri_test_uv(*args)
    return hit, t


def ray_triangle(o, d, p0, p1, p2):
    """Moller-Trumbore on (..., 3) vectors.  Returns (t, u, v, hit) with
    t = inf where there is no hit (no maxt)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = vcross(d, e2)
    det = dot(e1, pvec)
    inv_det = safe_div(1.0, det, DET_EPS)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = vcross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) > DET_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 0.0))
    return torch.where(hit, t, float("inf")), u, v, hit
