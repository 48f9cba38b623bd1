"""Triangle meshes and the rectangle/cube generators
(mitsuba_tpu/models/shapes.py).

The generators are host-side numpy, as in the JAX package; ``Mesh.make``
copies the arrays to the scene's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Mesh:
    """A triangle mesh in world space."""

    vertices: torch.Tensor         # (V, 3) float32
    faces: torch.Tensor            # (F, 3) int64
    normals: torch.Tensor | None   # (V, 3) or None (flat shading)
    uvs: torch.Tensor | None       # (V, 2) or None
    id: str = "mesh"
    bsdf_index: int = 0
    emitter_index: int = -1        # -1: not an emitter

    @staticmethod
    def make(vertices, faces, normals=None, uvs=None, device="cpu", **kw):
        def f32(x):
            return None if x is None else torch.tensor(
                np.asarray(x, np.float32), device=device)

        return Mesh(
            vertices=f32(vertices),
            faces=torch.tensor(np.asarray(faces, np.int64), device=device),
            normals=f32(normals),
            uvs=f32(uvs),
            **kw,
        )


def rectangle(to_world=None):
    """Unit rectangle [-1,1]^2 in the z=0 plane, +z normal (rectangle.cpp)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    return _apply_to_world(v, f, n, uv, to_world)


def cube(to_world=None):
    """Axis-aligned [-1,1]^3 cube with outward normals (cube.cpp)."""
    vs, fs, ns, uvs = [], [], [], []
    base_v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    base_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    base_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    rots = [
        np.eye(3),
        np.diag([1.0, -1.0, -1.0]),
        np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0.]]),
        np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0.]]),
        np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0.]]),
        np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0.]]),
    ]
    off = 0
    for R in rots:
        R = np.asarray(R, np.float32)
        v = (base_v + np.array([0, 0, 1.0], np.float32)) @ R.T
        n = np.tile((np.array([0, 0, 1.0], np.float32) @ R.T)[None], (4, 1))
        vs.append(v)
        ns.append(n)
        uvs.append(base_uv)
        fs.append(base_f + off)
        off += 4
    return _apply_to_world(np.concatenate(vs), np.concatenate(fs),
                           np.concatenate(ns), np.concatenate(uvs), to_world)


def _apply_to_world(v, f, n, uv, to_world):
    if to_world is not None:
        m = np.asarray(to_world, np.float32)
        v = v @ m[:3, :3].T + m[:3, 3]
        n = n @ np.linalg.inv(m[:3, :3])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        if np.linalg.det(m[:3, :3]) < 0:   # mirroring transform: flip winding
            f = f[:, ::-1].copy()
    return v, f, n, uv
