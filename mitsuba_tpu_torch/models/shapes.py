"""Triangle meshes and the rectangle/disk/cube/icosphere/cylinder
generators (mitsuba_tpu/models/shapes.py), the tessellated curve tubes
(``linear_curve_mesh``, ``bspline_curve_mesh``; the exact curve prims are
models/analytic.py's) and ``instance_meshes``, which flattens a mesh's
instances into copies (the twin of models/instancing.py's groups).

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
from ..core.math import cross, dot, normalize, sqrt
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
        return 0.5 * sqrt(torch.clamp(
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
        area = 0.5 * sqrt(torch.clamp(dot(cr, cr),
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


def cylinder_mesh(n_seg: int = 32, p0=(0, 0, 0), p1=(0, 0, 1), radius=1.0,
                  to_world=None, capped=False):
    """Open cylinder from p0 to p1 of ``n_seg`` sides, outward normals,
    optionally closed by two fans (cylinder.cpp analogue, the JAX
    package's ``cylinder_mesh``)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = float(np.linalg.norm(axis))
    axis /= max(length, 1e-20)
    # an orthonormal frame around the axis
    h = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0, 1.0, 0])
    s = np.cross(axis, h)
    s /= np.linalg.norm(s)
    t = np.cross(axis, s)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = (np.outer(np.cos(ang), s) + np.outer(np.sin(ang), t)) * radius
    v = np.concatenate([p0[None] + ring, p1[None] + ring]).astype(np.float32)
    n_out = np.concatenate([ring, ring]) / radius
    f = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        f.append([i, n_seg + i, n_seg + j])
        f.append([i, n_seg + j, j])
    uv = np.stack([np.concatenate([ang, ang]) / (2 * np.pi),
                   np.concatenate([np.zeros(n_seg), np.ones(n_seg)])],
                  axis=-1).astype(np.float32)
    if capped:
        base = len(v)
        v = np.concatenate([v, p0[None], p1[None]]).astype(np.float32)
        n_out = np.concatenate([n_out, -axis[None], axis[None]])
        uv = np.concatenate([uv, [[0.5, 0.0], [0.5, 1.0]]]).astype(np.float32)
        for i in range(n_seg):
            j = (i + 1) % n_seg
            f.append([base, j, i])                       # bottom cap
            f.append([base + 1, n_seg + i, n_seg + j])   # top cap
    return _apply_to_world(v, np.asarray(f, np.int32),
                           n_out.astype(np.float32), uv, to_world)


def instance_meshes(mesh, transforms):
    """The mesh replicated under each 4 x 4 of ``transforms`` (the
    flattened twin of a shape group's instances, shapegroup.cpp /
    instance.cpp): one Mesh a transform, on the mesh's device."""
    out = []
    v0 = mesh.vertices.detach().cpu().numpy()
    n0 = (mesh.normals.detach().cpu().numpy() if mesh.normals is not None
          else np.zeros_like(v0))
    uv0 = (mesh.uvs.detach().cpu().numpy() if mesh.uvs is not None
           else np.zeros((v0.shape[0], 2), np.float32))
    for k, m4 in enumerate(transforms):
        v, f, n, uv = _apply_to_world(v0, mesh.faces.cpu().numpy(), n0, uv0,
                                      np.asarray(m4, np.float32))
        out.append(Mesh.make(
            v, f, normals=n if mesh.normals is not None else None, uvs=uv,
            device=mesh.vertices.device, bsdf_index=mesh.bsdf_index,
            emitter_index=mesh.emitter_index, id=f"{mesh.id}_inst{k}"))
    return out


def _sweep_tube(centers, radii, n_seg, to_world=None):
    """A circular cross-section of ``n_seg`` vertices swept along the
    polyline ``centers`` (radii per point) with parallel-transported
    frames and smooth normals: (v, f, n, uv), open at both ends."""
    centers = np.asarray(centers, np.float32)
    radii = np.broadcast_to(np.asarray(radii, np.float32),
                            (centers.shape[0],))
    k = centers.shape[0]
    if k < 2:
        raise ValueError("a tube needs at least two centres")
    tang = np.zeros_like(centers)
    tang[0] = centers[1] - centers[0]
    tang[-1] = centers[-1] - centers[-2]
    tang[1:-1] = centers[2:] - centers[:-2]
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)

    def helper(t):
        return np.array([1.0, 0, 0]) if abs(t[0]) < 0.9 else \
            np.array([0, 1.0, 0])

    s = np.cross(tang[0], helper(tang[0]))
    s /= np.linalg.norm(s)
    frames = [(s, np.cross(tang[0], s))]
    for i in range(1, k):
        s_prev = frames[-1][0]
        s_i = s_prev - tang[i] * np.dot(tang[i], s_prev)
        nrm = np.linalg.norm(s_i)
        if nrm < 1e-8:
            s_i = np.cross(tang[i], helper(tang[i]))
            nrm = np.linalg.norm(s_i)
        s_i /= nrm
        frames.append((s_i, np.cross(tang[i], s_i)))
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    vs, ns, uvs = [], [], []
    for i in range(k):
        s_i, t_i = frames[i]
        ring_n = np.outer(np.cos(ang), s_i) + np.outer(np.sin(ang), t_i)
        vs.append(centers[i][None] + ring_n * radii[i])
        ns.append(ring_n)
        uvs.append(np.stack([ang / (2 * np.pi),
                             np.full(n_seg, i / (k - 1))], -1))
    f = []
    for i in range(k - 1):
        for a in range(n_seg):
            b = (a + 1) % n_seg
            i0, i1 = i * n_seg + a, i * n_seg + b
            j0, j1 = (i + 1) * n_seg + a, (i + 1) * n_seg + b
            # outward winding: the faces' normals agree with the rings'
            f.append([i0, j1, j0])
            f.append([i0, i1, j1])
    return _apply_to_world(np.concatenate(vs).astype(np.float32),
                           np.asarray(f, np.int32),
                           np.concatenate(ns).astype(np.float32),
                           np.concatenate(uvs).astype(np.float32), to_world)


def linear_curve_mesh(control_points, radii, n_seg: int = 8, to_world=None):
    """The linear curve through ``control_points`` swept into a tube of
    ``n_seg`` sides (linearcurve.cpp tessellated): (v, f, n, uv)."""
    return _sweep_tube(control_points, radii, n_seg, to_world)


def bspline_centerline(control_points, radii, subdiv: int = 4):
    """Centres and radii of the uniform cubic B-spline of
    ``control_points`` (ends clamped by repeating the first and last
    point; bsplinecurve.cpp's basis), ``subdiv`` samples a segment and
    the curve's end: (P, 3), (P,)."""
    cp = np.asarray(control_points, np.float32)
    r = np.broadcast_to(np.asarray(radii, np.float32), (cp.shape[0],))
    cp = np.concatenate([cp[:1], cp, cp[-1:]])
    r = np.concatenate([r[:1], r, r[-1:]])
    ts = np.linspace(0.0, 1.0, subdiv, endpoint=False)
    pts, rads = [], []
    for i in range(cp.shape[0] - 3):
        p, rr = cp[i:i + 4], r[i:i + 4]
        for t in ts:
            w = np.array([(1 - t) ** 3 / 6.0,
                          (3 * t ** 3 - 6 * t ** 2 + 4) / 6.0,
                          (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6.0,
                          t ** 3 / 6.0], np.float32)
            pts.append(w @ p)
            rads.append(float(w @ rr))
    pts.append((cp[-3] + 4.0 * cp[-2] + cp[-1]) / 6.0)
    rads.append(float((r[-3] + 4.0 * r[-2] + r[-1]) / 6.0))
    return np.asarray(pts, np.float32), np.asarray(rads, np.float32)


def bspline_curve_mesh(control_points, radii, n_seg: int = 8, subdiv: int = 4,
                       to_world=None):
    """The cubic B-spline of ``control_points`` swept into a tube
    (bsplinecurve.cpp tessellated): ``bspline_centerline`` at ``subdiv``
    samples a segment, ``n_seg`` sides: (v, f, n, uv)."""
    pts, rads = bspline_centerline(control_points, radii, subdiv)
    return _sweep_tube(pts, rads, n_seg, to_world)
