"""Build the port's Scene from plain numpy arrays.

This is how a scene made elsewhere (for example by the JAX package) is
carried across: the caller exports its arrays into a dict and
``scene_from_numpy`` rebuilds the same scene here, on the chosen device.

Layout of ``d``::

    {"meshes": [{"vertices": (V, 3), "faces": (F, 3), "uvs": (V, 2) | None,
                 "normals": (V, 3) | None, "bsdf_index": int,
                 "emitter_index": int, "id": str}, ...],
     "bsdfs": [{"type": "diffuse", "reflectance": (3,)}
               | {"type": "conductor", "eta": (3,), "k": (3,)}
               | {"type": "dielectric", "eta": float}
               | {"type": "roughconductor", "eta": (3,), "k": (3,),
                  "alpha": float}
               | {"type": "roughdielectric", "eta": float, "alpha": float},
               ...],   # each but diffuse may add "specular_reflectance"
                       # (3,), the dielectrics "specular_transmittance"
     "emitters": [{"type": "area", "radiance": (3,),
                   "sampling_weight": float}, ...],
     "sensor": {"to_world": (4, 4), "fov": float, "fov_axis": str,
                "near_clip": float, "far_clip": float, "width": int,
                "height": int, "rfilter": "gaussian" | "box",
                "sample_count": int}}
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.bsdfs import (RoughConductor, RoughDielectric, SmoothConductor,
                           SmoothDielectric, SmoothDiffuse)
from .models.emitters import AreaEmitter
from .models.film import Film, ReconstructionFilter
from .models.samplers import IndependentSampler
from .models.scene import make_scene
from .models.sensors import PerspectiveCamera
from .models.shapes import Mesh
from .models.textures import ConstantTexture

_NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue 1, item 2: plastic, "
               "textures and envmaps)")


BSDF_TYPES = {"conductor": SmoothConductor, "dielectric": SmoothDielectric,
              "roughconductor": RoughConductor,
              "roughdielectric": RoughDielectric}


def scene_from_numpy(d, device=None):
    """The port's Scene for the arrays in ``d`` (see the module docstring),
    on ``device`` (default: the GPU)."""
    device = resolve_device(device)

    def vec(v):
        return torch.tensor(np.asarray(v, np.float32).reshape(3),
                            device=device)

    def rgb(v):
        return ConstantTexture(vec(v))

    def scalar(v):
        return torch.tensor(float(v), device=device)

    def bsdf(b):
        kind = b["type"]
        if kind == "diffuse":
            return SmoothDiffuse(reflectance=rgb(b["reflectance"]))
        if kind not in BSDF_TYPES:
            raise NotImplementedError(f"BSDF type {kind!r} {_NOT_PORTED}")
        kw = {k: rgb(b[k]) for k in ("specular_reflectance",
                                     "specular_transmittance")
              if b.get(k) is not None}
        if kind in ("conductor", "roughconductor"):
            kw.update(eta=vec(b["eta"]), k=vec(b["k"]))
        else:
            kw.update(eta=scalar(b["eta"]))
        if kind.startswith("rough"):
            kw.update(alpha=scalar(b["alpha"]))
        return BSDF_TYPES[kind](**kw)

    bsdfs = [bsdf(b) for b in d["bsdfs"]]
    emitters = []
    for e in d["emitters"]:
        if e["type"] != "area":
            raise NotImplementedError(f"emitter type {e['type']!r} {_NOT_PORTED}")
        emitters.append(AreaEmitter(
            radiance=rgb(e["radiance"]),
            sampling_weight=float(e.get("sampling_weight", 1.0))))
    meshes = [
        Mesh.make(m["vertices"], m["faces"], normals=m.get("normals"),
                  uvs=m.get("uvs"), bsdf_index=int(m["bsdf_index"]),
                  emitter_index=int(m.get("emitter_index", -1)),
                  id=m.get("id", "mesh"), device=device)
        for m in d["meshes"]]
    s = d["sensor"]
    rfilter = {"gaussian": ReconstructionFilter.gaussian,
               "box": ReconstructionFilter.box}[s.get("rfilter", "gaussian")]()
    sensor = PerspectiveCamera(
        to_world=torch.tensor(np.asarray(s["to_world"], np.float32),
                              device=device),
        film=Film(width=int(s["width"]), height=int(s["height"]),
                  rfilter=rfilter),
        fov=float(s["fov"]), fov_axis=s.get("fov_axis", "x"),
        near_clip=float(s["near_clip"]), far_clip=float(s["far_clip"]),
        sampler=IndependentSampler(int(s.get("sample_count", 16))),
    )
    return make_scene(meshes, bsdfs, emitters, sensor, device)
