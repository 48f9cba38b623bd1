"""4x4 affine transforms as host-side float32 numpy arrays
(mitsuba_tpu/core/transform.py).

Scene construction composes these on the host; the results are copied
to the scene's device once, by the shape and sensor constructors.
``apply_vector`` also takes tensors, and ``inverse`` inverts one (the
environment map's rotation).
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32


def _normalize(v):
    v = np.asarray(v, _F32)
    return v * (_F32(1.0) / np.sqrt(np.sum(v * v, dtype=_F32)))


def translate(v):
    m = np.eye(4, dtype=_F32)
    m[:3, 3] = np.asarray(v, _F32)
    return m


def scale(v):
    v = np.broadcast_to(np.asarray(v, _F32), (3,))
    return np.diag(np.concatenate([v, np.ones(1, _F32)])).astype(_F32)


def rotate(axis, angle_deg):
    """Rotation about a (not necessarily unit) axis, angle in degrees."""
    a = _normalize(axis)
    theta = np.deg2rad(_F32(angle_deg))
    s, c = np.sin(theta), np.cos(theta)
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], _F32)
    R = np.eye(3, dtype=_F32) * c + s * K + (_F32(1.0) - c) * np.outer(a, a)
    m = np.eye(4, dtype=_F32)
    m[:3, :3] = R
    return m


def look_at(origin, target, up):
    """Camera-to-world transform: +z looks from origin toward target;
    column 0 holds the camera's left vector (transform.h look_at)."""
    origin = np.asarray(origin, _F32)
    dir_ = _normalize(np.asarray(target, _F32) - origin)
    left = _normalize(np.cross(_normalize(up), dir_))
    new_up = np.cross(dir_, left)
    m = np.eye(4, dtype=_F32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dir_
    m[:3, 3] = origin
    return m


def compose(*ms):
    """compose(A, B, C) == A @ B @ C (applied right-to-left)."""
    out = np.asarray(ms[0], _F32)
    for m in ms[1:]:
        out = out @ np.asarray(m, _F32)
    return out


def apply_vector(m, v):
    """The (4, 4) transform ``m``'s linear part applied to vectors (..., 3):
    explicit multiplies and adds in the JAX package's order, for numpy
    arrays and tensors alike."""
    return (v[..., 0:1] * m[:3, 0] + v[..., 1:2] * m[:3, 1]
            + v[..., 2:3] * m[:3, 2])


def inverse(m):
    """The inverse of a (4, 4) float32 tensor, on its device: computed on
    the host in float32 by LAPACK, which gives the JAX package's bits (a
    float64 inverse rounded to float32 parts from them by an ulp, enough
    to move a direction across an environment map's cell boundary)."""
    return torch.linalg.inv(m.detach().cpu()).to(m.device)
