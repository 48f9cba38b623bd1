"""Scene: geometry aggregation and plugin wiring (mitsuba_tpu/models/scene.py;
reference src/render/scene.cpp).

All shapes are triangle meshes, concatenated into one global
vertex/face buffer by ``geometry()``; static per-face shape ids map a hit
back to its shape and so to its BSDF and emitter.  A scene of more
faces than the brute megakernel takes (``MAX_FACES``) gets a host-built
BVH (ops/bvh.py) at ``make_scene``, as the JAX package's does
(scene.py:924-985, without its TPU-only packet accel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.bvh import BVH, build_bvh
from ..ops.megakernel import MAX_FACES


@dataclass
class Scene:
    meshes: tuple          # tuple[Mesh, ...]
    bsdfs: tuple
    emitters: tuple
    sensor: object
    device: torch.device
    shape_bsdf: tuple = ()       # per-shape BSDF index
    shape_emitter: tuple = ()    # per-shape emitter index (-1: none)
    emitter_shape: tuple = ()    # per-emitter shape index (-1: none)
    accel: BVH | None = None     # over geometry(); None at <= MAX_FACES
    scene_center: tuple = (0.0, 0.0, 0.0)   # bounding sphere of the
    scene_radius: float = 1.0                # vertices (scene.py:867-884)

    def geometry(self):
        """Concatenated (vertices, faces, normals, uvs), face indices
        rebased.  Flat meshes contribute their vertices as placeholder
        normal rows, as in the JAX package."""
        vs, fs, ns, uvs = [], [], [], []
        off = 0
        for m in self.meshes:
            nv = m.vertices.shape[0]
            vs.append(m.vertices)
            fs.append(m.faces + off)
            ns.append(m.normals if m.normals is not None else m.vertices)
            uvs.append(m.uvs if m.uvs is not None
                       else torch.zeros((nv, 2), device=self.device))
            off += nv
        return torch.cat(vs), torch.cat(fs), torch.cat(ns), torch.cat(uvs)


def make_scene(meshes, bsdfs, emitters, sensor, device):
    """Assemble a Scene from meshes wired to their plugins by each mesh's
    ``bsdf_index`` / ``emitter_index`` (reference Scene ctor,
    scene.cpp:22-96).  Every tensor must already live on ``device``.
    Above ``MAX_FACES`` faces in all, the BVH is built on the host."""
    meshes, bsdfs, emitters = tuple(meshes), tuple(bsdfs), tuple(emitters)
    emitter_shape = tuple(
        next((s for s, m in enumerate(meshes) if m.emitter_index == e), -1)
        for e in range(len(emitters)))
    # scene bounding sphere, in float32 as the JAX package computes it
    all_v = np.concatenate([m.vertices.cpu().numpy() for m in meshes])
    center = all_v.mean(axis=0)
    radius = max(float(np.max(np.linalg.norm(all_v - center, axis=1))), 1e-3)
    scene = Scene(
        meshes=meshes, bsdfs=bsdfs, emitters=emitters, sensor=sensor,
        device=torch.device(device),
        shape_bsdf=tuple(int(m.bsdf_index) for m in meshes),
        shape_emitter=tuple(int(m.emitter_index) for m in meshes),
        emitter_shape=emitter_shape,
        scene_center=tuple(float(c) for c in center),
        scene_radius=radius,
    )
    if sum(int(m.faces.shape[0]) for m in meshes) > MAX_FACES:
        v, f, _, _ = scene.geometry()
        scene.accel = build_bvh(v.cpu().numpy(), f.cpu().numpy(),
                                device=device)
    return scene
