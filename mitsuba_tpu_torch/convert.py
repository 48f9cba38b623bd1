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
               | {"type": "twosided", "nested": <one of these dicts>}
               | {"type": "dispersive_dielectric", "int_ior_d": float,
                  "int_V_d": float, "ext_ior_d": float, "ext_V_d": float},
               ...],   # the conductors and dielectrics may add
                       # "specular_reflectance" (3,), the dielectrics
                       # "specular_transmittance" (3,)
     "emitters": [{"type": "area" | "directionalarea", "radiance": (3,)}
                  | {"type": "envmap", "data": (H, W, 3), "scale": float,
                     "to_world": (4, 4)}
                  | {"type": "point", "intensity": (3,), "position": (3,)}
                  | {"type": "spot", "intensity": (3,), "position": (3,),
                     "direction": (3,), "cutoff_angle": float,
                     "beam_width": float}
                  | {"type": "projector", "irradiance": TEX,
                     "position": (3,), "direction": (3,), "up": (3,),
                     "scale": float, "fov": float, "aspect": float}
                  | {"type": "constant", "radiance": (3,)}
                  | {"type": "directional", "irradiance": (3,),
                     "direction": (3,)}, ...],
                  # each may add "sampling_weight": float
     "analytic": [{"type": "sphere" | "disk" | "cylinder" | "linearcurve"
                           | "bsplinecurve", <its parameters, as
                   models/analytic.py analytic_prim takes them>,
                   "bsdf_index": int, "emitter_index": int}, ...]
                 | {<AnalyticShapes' field>: array, ...},  # optional
     "sdf": {"values": (D, H, W), "bbox_min": (3,), "bbox_max": (3,),
             "bsdf_index": int},                         # optional
     "instances": [{"submeshes": [<a "meshes" entry>, ...],
                    "transforms": (I, 4, 4), "id": str}, ...],  # optional
     "sensor": {"to_world": (4, 4), "fov": float, "fov_axis": str,
                "near_clip": float, "far_clip": float, "width": int,
                "height": int, "rfilter": "gaussian" | "box" | "tent"
                | "mitchell" | "catmullrom" | "lanczos",
                "sample_count": int}
               | {"type": "realisticlens", ...}}   # lens_camera_from_numpy

where the analytic prims (exact spheres, disks and cylinders) are either
shape dicts or a JAX ``AnalyticShapes``' arrays under its field names
(``sp_center``, ``sp_radius``, ``dk_*``, ``cy_*``, the ``cv_*`` curve
rows, and the per-prim ``bsdf_index``, ``emitter_index``,
``flip_normals`` and ``ids``), the SDF grid and the instanced groups are
those of models/sdf.py and models/instancing.py (a group's submeshes
in object space), and a texture TEX is
a constant (3,) or a bitmap
``{"data": (H, W, 1 | 3), "filter": "bilinear" | "nearest",
"wrap": "repeat" | "clamp"}`` (bitmap.cpp's filter_type and wrap_mode).
An envmap may also carry its sampling distribution (``Marginal2D``'s
arrays: "pdf_table" (H, W), "row_cdf" (H,), "cond_cdf" (H, W),
"row_weight" (H,), "total"); given them, it samples that table, as the
JAX package's does, and otherwise builds its own.

``lens_camera_from_numpy`` carries a realistic-lens camera across: its
interfaces, glasses, exit-pupil table and pose, as they are (no
autofocus, no table computed).  ``lens_from_numpy`` carries a lens across
the same way: the JAX
``LensSystem``'s prescription and, optionally, a JAX
``DesignProblem.params()`` dict (numpy) give the port's ``LensSystem`` and
its parameters, so that both packages optimize the same lens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .models.bsdfs import (DispersiveDielectric, RoughConductor,
                           RoughDielectric, RoughPlastic, SmoothConductor,
                           SmoothDielectric, SmoothDiffuse, SmoothPlastic,
                           TwoSided)
from .core.distr2d import Marginal2D
from .lens.camera import RealisticLensCamera
from .lens.elements import (ApertureStop, AsphericalLens, PlanoLens,
                            SpheroidLens)
from .lens.lens_system import LensMaterial, LensSystem
from .lens.materials import DispersiveMaterial
from .lens.surfaces import ConicSurface, EvenAsphericSurface
from .models.analytic import AnalyticShapes, analytic_prim, build_analytic
from .models.emitters import (AreaEmitter, ConstantEmitter,
                              DirectionalAreaEmitter, DirectionalEmitter,
                              EnvmapEmitter, PointEmitter, ProjectorEmitter,
                              SpotEmitter)
from .models.film import Film, ReconstructionFilter
from .models.instancing import InstancedGroup
from .models.samplers import IndependentSampler
from .models.scene import make_scene
from .models.sdf import SDFGrid
from .models.sensors import PerspectiveCamera
from .models.shapes import Mesh
from .models.textures import BitmapTexture, ConstantTexture

DISTR_KEYS = ("pdf_table", "row_cdf", "cond_cdf", "row_weight", "total")
_BSDF_NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue 1: item 6 for the "
                    "rest of the plugin set, item 7 for the polarizing and "
                    "measured polarized ones)")


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
        if kind == "dispersive_dielectric":
            return DispersiveDielectric(**{k: scalar(b[k]) for k in (
                "int_ior_d", "int_V_d", "ext_ior_d", "ext_V_d")})
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
        if e["type"] in ("area", "directionalarea"):
            kind = (AreaEmitter if e["type"] == "area"
                    else DirectionalAreaEmitter)
            return kind(radiance=rgb(e["radiance"]), sampling_weight=weight)
        kind = e["type"]
        if kind in ("point", "spot"):
            kw = dict(intensity=vec(e["intensity"]),
                      position=vec(e["position"]), sampling_weight=weight)
            if kind == "point":
                return PointEmitter(**kw)
            return SpotEmitter(direction=vec(e["direction"]),
                               cutoff_angle=float(e["cutoff_angle"]),
                               beam_width=float(e["beam_width"]), **kw)
        if kind == "projector":
            return ProjectorEmitter(
                irradiance=texture(e["irradiance"]),
                position=vec(e["position"]), direction=vec(e["direction"]),
                up=vec(e["up"]), scale=scalar(e["scale"]),
                fov=float(e["fov"]), aspect=float(e.get("aspect", 1.0)),
                sampling_weight=weight)
        if kind == "constant":
            return ConstantEmitter(radiance=vec(e["radiance"]),
                                   sampling_weight=weight)
        if kind == "directional":
            return DirectionalEmitter(irradiance=vec(e["irradiance"]),
                                      direction=vec(e["direction"]),
                                      sampling_weight=weight)
        if kind != "envmap":
            raise ValueError(f"unknown emitter type {kind!r}")
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

    def mesh(m):
        return Mesh.make(m["vertices"], m["faces"], normals=m.get("normals"),
                         uvs=m.get("uvs"), bsdf_index=int(m["bsdf_index"]),
                         emitter_index=int(m.get("emitter_index", -1)),
                         id=m.get("id", "mesh"), device=device)

    meshes = [mesh(m) for m in d["meshes"]]
    s = d["sensor"]
    if s.get("type") == "realisticlens":
        sensor = lens_camera_from_numpy(s, device)
    else:
        sensor = PerspectiveCamera(
            to_world=torch.tensor(np.asarray(s["to_world"], np.float32),
                                  device=device),
            film=_film(s), fov=float(s["fov"]),
            fov_axis=s.get("fov_axis", "x"),
            near_clip=float(s["near_clip"]), far_clip=float(s["far_clip"]),
            sampler=IndependentSampler(int(s.get("sample_count", 16))))
    analytic = (analytic_from_numpy(d["analytic"], device)
                if d.get("analytic") is not None else None)
    sdf = None
    if d.get("sdf") is not None:
        g = d["sdf"]
        sdf = SDFGrid(**{k: torch.tensor(np.asarray(g[k], np.float32),
                                         device=device)
                         for k in ("values", "bbox_min", "bbox_max")},
                      bsdf_index=int(g.get("bsdf_index", 0)),
                      id=g.get("id", "sdfgrid"))
    instances = [InstancedGroup.create([mesh(m) for m in g["submeshes"]],
                                       np.asarray(g["transforms"], np.float32),
                                       id=g.get("id", "group"), device=device)
                 for g in d.get("instances") or ()]
    return make_scene(meshes, bsdfs, emitters, sensor, device,
                      analytic=analytic, sdf=sdf, instances=instances)


def analytic_from_numpy(a, device=None):
    """The port's AnalyticShapes for the "analytic" entry of
    ``scene_from_numpy``'s layout, on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    if not isinstance(a, dict):
        return build_analytic(
            [analytic_prim(p, int(p.get("bsdf_index", 0)),
                           int(p.get("emitter_index", -1))) for p in a],
            device=device)
    meta = ("bsdf_index", "emitter_index", "flip_normals", "ids")
    return AnalyticShapes(
        **{f.name: torch.tensor(np.asarray(a[f.name], np.float32),
                                device=device)
           for f in dataclasses.fields(AnalyticShapes)
           if f.name not in meta + ("any_cubic",)},
        bsdf_index=tuple(int(x) for x in a["bsdf_index"]),
        emitter_index=tuple(int(x) for x in a["emitter_index"]),
        flip_normals=tuple(bool(x) for x in a["flip_normals"]),
        ids=tuple(str(x) for x in a["ids"]),
        any_cubic=bool(a.get("any_cubic",
                             np.asarray(a["cv_cubic"]).any())))


def _film(s):
    rfilter = getattr(ReconstructionFilter, s.get("rfilter", "gaussian"))()
    return Film(width=int(s["width"]), height=int(s["height"]),
                rfilter=rfilter)


_ELEMENTS = {"sphere": SpheroidLens, "plane": PlanoLens,
             "aperture": ApertureStop, "asphere": AsphericalLens}


def lens_camera_from_numpy(d, device=None):
    """The port's RealisticLensCamera for the arrays of a JAX one, on
    ``device`` (default: the GPU).

    Layout of ``d``::

        {"type": "realisticlens",
         "interfaces": [{"kind": "sphere" | "plane" | "aperture"
                                 | "asphere",
                         <its tensor fields>: float | (A,),
                         "newton_iters": int (asphere),
                         "left": GLASS, "right": GLASS}, ...],  # rear first
         "to_world": (4, 4), "pupil_min": (S, 2), "pupil_max": (S, 2),
         "film_z_position": float, "width": int, "height": int,
         "rfilter": str, "sample_count": int, "diagonal": float,
         "near_clip": float, "far_clip": float,
         "sample_exit_pupil": bool, "spectral": bool,
         "shutter_open_time": float}

    where a GLASS is {"name": str, "cauchy": (2,), "sellmeier_B": (3,),
    "sellmeier_C": (3,), "use_cauchy": bool}."""
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def glass(g):
        return DispersiveMaterial(
            cauchy=f32(g["cauchy"]), sellmeier_B=f32(g["sellmeier_B"]),
            sellmeier_C=f32(g["sellmeier_C"]),
            use_cauchy=bool(g["use_cauchy"]), name=g.get("name", ""))

    def element(e):
        cls = _ELEMENTS[e["kind"]]
        kw = {f.name: f32(e[f.name]) for f in dataclasses.fields(cls)
              if f.type == "torch.Tensor"}
        if cls is AsphericalLens:
            kw["newton_iters"] = int(e.get("newton_iters", 10))
        return cls(left=glass(e["left"]), right=glass(e["right"]), **kw)

    return RealisticLensCamera(
        interfaces=tuple(element(e) for e in d["interfaces"]),
        to_world=f32(d["to_world"]), pupil_min=f32(d["pupil_min"]),
        pupil_max=f32(d["pupil_max"]),
        film_z_position=f32(d["film_z_position"]), film=_film(d),
        sampler=IndependentSampler(int(d.get("sample_count", 16))),
        diagonal=float(d["diagonal"]), near_clip=float(d["near_clip"]),
        far_clip=float(d["far_clip"]),
        sample_exit_pupil=bool(d["sample_exit_pupil"]),
        spectral=bool(d["spectral"]),
        shutter_open_time=float(d.get("shutter_open_time", 1.0)))


def lens_from_numpy(d, params=None, device=None):
    """(the port's LensSystem, its parameters by name) for the JAX
    ``LensSystem``'s prescription ``d``, on ``device`` (default: the GPU),
    with the values of ``params`` (a JAX ``DesignProblem.params()`` dict
    as numpy) in place where given.

    Layout of ``d``::

        {"surfaces": [{"type": "conic" | "even_aspheric",
                       "radial_extent": float, "c": float (dimensionless,
                       c * radial_extent, as stored), "K": float,
                       "z0": float, "ai": (7,) (even_aspheric)}, ...],
         "materials": [{"name": str, "ior": float, "V_d": float}, ...],
                       # all of them, the film side's air first
         "aperture_index": int, "n_rings": int, "n_sectors": int,
         "baffle_scale": float}
    """
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    surfaces = []
    for sd in d["surfaces"]:
        kw = dict(radial_extent=float(sd["radial_extent"]), c=f32(sd["c"]),
                  K=f32(sd["K"]), z0=f32(sd["z0"]))
        if sd["type"] == "even_aspheric":
            surfaces.append(EvenAsphericSurface(ai=f32(sd["ai"]), **kw))
        else:
            surfaces.append(ConicSurface(**kw))
    materials = tuple(LensMaterial(ior=f32(m["ior"]), V_d=f32(m["V_d"]),
                                   name=m["name"]) for m in d["materials"])
    ls = LensSystem(surfaces=tuple(surfaces), materials=materials,
                    aperture_index=int(d["aperture_index"]),
                    n_rings=int(d["n_rings"]), n_sectors=int(d["n_sectors"]),
                    baffle_scale=float(d["baffle_scale"]))
    if params is not None:
        ls = ls.with_params({k: f32(v) for k, v in params.items()})
    return ls, ls.params()


def integrator_from_settings(d):
    """A projective integrator from its settings ``d``: {"id":
    "prb_projective" | "direct_projective", and the JAX instance's
    fields by name} (``dataclasses.asdict`` of it); a field the port's
    class lacks raises."""
    from .models.integrators.projective import (DirectProjectiveIntegrator,
                                                PathProjectiveIntegrator)

    kinds = {c.id: c for c in (PathProjectiveIntegrator,
                               DirectProjectiveIntegrator)}
    d = dict(d)
    kind = d.pop("id")
    if kind not in kinds:
        raise NotImplementedError(f"integrator {kind!r} is not carried "
                                  "across: only the projective ones are")
    return kinds[kind](**d)
