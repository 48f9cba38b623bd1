"""Ray-triangle test shared by the plain versions of the kernels
(mitsuba_tpu/ops/intersect.py ``ray_triangle``, in the megakernel's
order of operations: csrc/path_common.cuh ``tri_test``)."""
from __future__ import annotations

import torch

DET_EPS = 1e-9


def cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def tri_test(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z,
             ox, oy, oz, dx, dy, dz, maxt):
    """Moller-Trumbore on broadcastable components: the triangle's
    (p0, e1, e2) may be Python floats or tensors.  Returns (hit, t) where
    ``hit`` includes ``0 < t <= maxt``."""
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
    return hit, t
