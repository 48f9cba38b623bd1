"""Build the port's Scene from plain numpy arrays.

This is how a scene made elsewhere (for example by the JAX package) is
carried across: the caller exports its arrays into a dict and
``scene_from_numpy`` rebuilds the same scene here, on the chosen device.

Layout of ``d``::

    {"meshes": [{"vertices": (V, 3), "faces": (F, 3), "uvs": (V, 2) | None,
                 "normals": (V, 3) | None, "bsdf_index": int,
                 "emitter_index": int, "id": str}, ...],
     "bsdfs": [{"type": "diffuse", "reflectance": TEX}
               | {"type": "conductor", "eta": (3,), "k": (3,)}
               | {"type": "dielectric", "eta": float}
               | {"type": "roughconductor", "eta": (3,), "k": (3,),
                  "alpha": float}
               | {"type": "roughdielectric", "eta": float, "alpha": float}
               | {"type": "plastic", "diffuse_reflectance": TEX,
                  "eta": float, "nonlinear": bool}
               | {"type": "roughplastic", "diffuse_reflectance": TEX,
                  "eta": float, "alpha": float, "nonlinear": bool}
               | {"type": "twosided", "nested": <one of these dicts>},
               ...],   # the conductors and dielectrics may add
                       # "specular_reflectance" (3,), the dielectrics
                       # "specular_transmittance" (3,)
     "emitters": [{"type": "area", "radiance": (3,),
                   "sampling_weight": float}
                  | {"type": "envmap", "data": (H, W, 3), "scale": float,
                     "to_world": (4, 4), "sampling_weight": float}, ...],
     "sensor": {"to_world": (4, 4), "fov": float, "fov_axis": str,
                "near_clip": float, "far_clip": float, "width": int,
                "height": int, "rfilter": "gaussian" | "box",
                "sample_count": int}}

where a texture TEX is a constant (3,) or a bitmap
``{"data": (H, W, 1 | 3), "filter": "bilinear" | "nearest",
"wrap": "repeat" | "clamp"}`` (bitmap.cpp's filter_type and wrap_mode).
An envmap may also carry its sampling distribution (``Marginal2D``'s
arrays: "pdf_table" (H, W), "row_cdf" (H,), "cond_cdf" (H, W),
"row_weight" (H,), "total"); given them, it samples that table, as the
JAX package's does, and otherwise builds its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .models.bsdfs import (RoughConductor, RoughDielectric, RoughPlastic,
                           SmoothConductor, SmoothDielectric, SmoothDiffuse,
                           SmoothPlastic, TwoSided)
from .core.distr2d import Marginal2D
from .models.emitters import AreaEmitter, EnvmapEmitter
from .models.film import Film, ReconstructionFilter
from .models.samplers import IndependentSampler
from .models.scene import make_scene
from .models.sensors import PerspectiveCamera
from .models.shapes import Mesh
from .models.textures import BitmapTexture, ConstantTexture

_NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue 1, item 6: the "
               "constant and directional emitters and the rest)")
DISTR_KEYS = ("pdf_table", "row_cdf", "cond_cdf", "row_weight", "total")
_BSDF_NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue 1, item 6: the "
                    "rest of the plugin set)")


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

    def texture(v):
        if not isinstance(v, dict):
            return rgb(v)
        return BitmapTexture(
            data=torch.tensor(np.asarray(v["data"], np.float32),
                              device=device),
            filter_nearest={"bilinear": False,
                            "nearest": True}[v.get("filter", "bilinear")],
            wrap_repeat={"repeat": True,
                         "clamp": False}[v.get("wrap", "repeat")])

    def scalar(v):
        return torch.tensor(float(v), device=device)

    def bsdf(b):
        kind = b["type"]
        if kind == "diffuse":
            return SmoothDiffuse(reflectance=texture(b["reflectance"]))
        if kind == "twosided":
            return TwoSided(nested=bsdf(b["nested"]))
        if kind in ("plastic", "roughplastic"):
            kw = dict(diffuse_reflectance=texture(b["diffuse_reflectance"]),
                      eta=scalar(b["eta"]),
                      nonlinear=bool(b.get("nonlinear", False)))
            if kind == "plastic":
                return SmoothPlastic(**kw)
            return RoughPlastic(alpha=scalar(b["alpha"]), **kw)
        if kind not in BSDF_TYPES:
            raise NotImplementedError(f"BSDF type {kind!r} {_BSDF_NOT_PORTED}")
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
    def emitter(e):
        weight = float(e.get("sampling_weight", 1.0))
        if e["type"] == "area":
            return AreaEmitter(radiance=rgb(e["radiance"]),
                               sampling_weight=weight)
        if e["type"] != "envmap":
            raise NotImplementedError(f"emitter type {e['type']!r} {_NOT_PORTED}")
        distr = None
        if all(k in e for k in DISTR_KEYS):
            distr = Marginal2D(**{k: torch.tensor(
                np.asarray(e[k], np.float32), device=device)
                for k in DISTR_KEYS})
        env = EnvmapEmitter.create(
            np.array(e["data"], np.float32), scale=float(e.get("scale", 1.0)),
            to_world=e.get("to_world"), device=device, distr=distr)
        return dataclasses.replace(env, sampling_weight=weight)

    emitters = [emitter(e) for e in d["emitters"]]
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
