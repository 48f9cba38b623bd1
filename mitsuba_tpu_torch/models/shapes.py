"""Triangle meshes and the rectangle/cube/icosphere generators
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


def sphere_mesh(subdiv: int = 4, to_world=None):
    """Icosphere approximation of the unit sphere (sphere.cpp analogue):
    each subdivision splits every face in four, so 20 * 4**subdiv faces,
    with smooth vertex normals and spherical uvs."""
    t = (1.0 + 5 ** 0.5) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid: dict[tuple[int, int], int] = {}
        verts = list(v)
        new_f = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_f += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(new_f, np.int64)
    v = v.astype(np.float32)
    n = v.copy()  # unit sphere: normal == position
    theta = np.arccos(np.clip(v[:, 2], -1, 1))
    phi = np.arctan2(v[:, 1], v[:, 0])
    uv = np.stack([(phi + np.pi) / (2 * np.pi), theta / np.pi],
                  axis=-1).astype(np.float32)
    return _apply_to_world(v, f.astype(np.int32), n, uv, to_world)


def _apply_to_world(v, f, n, uv, to_world):
    if to_world is not None:
        m = np.asarray(to_world, np.float32)
        v = v @ m[:3, :3].T + m[:3, 3]
        n = n @ np.linalg.inv(m[:3, :3])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        if np.linalg.det(m[:3, :3]) < 0:   # mirroring transform: flip winding
            f = f[:, ::-1].copy()
    return v, f, n, uv
