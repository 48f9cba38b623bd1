"""Triangle meshes and the rectangle/disk/cube/icosphere generators
(mitsuba_tpu/models/shapes.py).

The generators are host-side numpy, as in the JAX package; ``Mesh.make``
copies the arrays to the scene's device (the GPU unless the caller asks
for the CPU, as every entry point of the port).  Position sampling for area
lights is uniform by area (shape.h:348): a face from the face-area
distribution, then uniform barycentrics.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import warp
from ..core.distr import DiscreteDistribution
from ..device import resolve_device
from ..core.math import cross, dot, normalize
from ..core.records import PositionSample


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
    def make(vertices, faces, normals=None, uvs=None, device=None, **kw):
        """A mesh of the arrays on ``device`` (default: the GPU; pass
        ``device="cpu"`` for the CPU)."""
        device = resolve_device(device)

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

    def face_areas(self):
        tri = self.vertices[self.faces]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        return 0.5 * torch.sqrt(torch.clamp(
            dot(cross(e1, e2), cross(e1, e2)), min=1e-30))

    def surface_area(self):
        return torch.sum(self.face_areas())

    def sample_position(self, sample1, sample2,
                        face_distr: DiscreteDistribution):
        """Uniform-by-area position sample; sample1 (N,), sample2 (N, 2)."""
        fidx, face_pmf = face_distr.sample_pmf(sample1)
        return self._position(fidx, face_pmf,
                              warp.square_to_uniform_triangle(sample2))

    def _position(self, fidx, face_pmf, b):
        """The PositionSample at barycentrics ``b`` of faces ``fidx``."""
        f = self.faces[fidx]
        p0, p1, p2 = (self.vertices[f[:, 0]], self.vertices[f[:, 1]],
                      self.vertices[f[:, 2]])
        p = (p0 * (1.0 - b[..., 0] - b[..., 1])[:, None]
             + p1 * b[..., 0:1] + p2 * b[..., 1:2])
        cr = cross(p1 - p0, p2 - p0)
        area = 0.5 * torch.sqrt(torch.clamp(dot(cr, cr),
                                            min=1e-30))
        return PositionSample(
            p=p, n=normalize(cr), uv=b,
            pdf=face_pmf / torch.clamp(area, min=1e-20),
            delta=torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device))

    def sample_position_reuse(self, sample2,
                              face_distr: DiscreteDistribution):
        """A position uniform by area from one 2D sample: the face takes
        sample2.x, whose remainder in the face's bin is reused for the
        barycentrics (shape.h:348 sample_reuse)."""
        fidx, u_re, face_pmf = face_distr.sample_reuse_pmf(sample2[..., 0])
        return self._position(fidx, face_pmf, warp.square_to_uniform_triangle(
            torch.stack([u_re, sample2[..., 1]], dim=-1)))


def disk_mesh(n_seg: int = 64, to_world=None):
    """Unit disk in the z = 0 plane, +z normal, as a triangle fan of
    ``n_seg`` faces about its centre (disk.cpp analogue)."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_seg)], axis=-1)
    v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
    ring = np.arange(1, n_seg + 1, dtype=np.int32)
    f = np.stack([np.zeros(n_seg, np.int32), ring, np.roll(ring, -1)], -1)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (n_seg + 1, 1))
    uv = (v[:, :2] + 1) * 0.5
    return _apply_to_world(v, f, n, uv, to_world)


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
