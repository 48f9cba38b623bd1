"""Scenes from Mitsuba-style dicts (mitsuba_tpu/utils/load.py; reference
src/core/xml.cpp and the dict schema of ``mi.load_dict``).

``load_dict`` builds a Scene on the chosen device (default: the GPU; pass
``device="cpu"`` for the CPU) from the plugins the port has:

- BSDFs: diffuse, conductor, roughconductor, dielectric,
  roughdielectric, plastic, roughplastic (each with a constant or bitmap
  texture where it takes one), twosided, dispersive_dielectric; named
  BSDFs and ``{"type": "ref"}``; a shape without one gets the default
  diffuse;
- shapes: rectangle, cube, disk, cylinder, sphere, obj, ply, serialized,
  mesh, linearcurve and bsplinecurve as meshes, the sphere, disk,
  cylinder and curves as exact prims under ``"analytic": True``, merge,
  shapegroup + instance (``InstancedGroup``), sdfgrid;
- emitters: area and directionalarea on a shape; point, spot, projector,
  constant, directional and envmap (from data or a file), each with its
  ``sampling_weight``;
- the perspective and realisticlens sensors, hdrfilm with the box, tent,
  gaussian, mitchell, catmullrom and lanczos filters, the independent
  sampler;
- the integrators path, direct, depth, prb, prb_basic, ptracer,
  prb_projective and direct_projective: the scene's own, which
  ``render(scene)`` takes.

Every other plugin type raises ``NotImplementedError`` naming the item of
ROADMAP.md's Queue 1 that ports it (6: the rest of the plugin set, 7:
volumes and polarization, 8: the auxiliary modules); an unknown type
raises ``ValueError``, as the JAX package's loader does.  Where the JAX
loader gives an OBJ, PLY or serialized mesh without vertex normals zero
normals under a ``to_world`` (its smooth shading then has no normal),
the port keeps it flat (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transform as tf
from ..device import resolve_device
from ..models import shapes as shp
from ..models.analytic import analytic_prim, build_analytic
from ..models.bsdfs import (CONDUCTOR_IOR, DispersiveDielectric,
                            RoughConductor, RoughDielectric, RoughPlastic,
                            SmoothConductor, SmoothDielectric, SmoothDiffuse,
                            SmoothPlastic, TwoSided)
from ..models.emitters import (AreaEmitter, ConstantEmitter,
                               DirectionalAreaEmitter, DirectionalEmitter,
                               EnvmapEmitter, PointEmitter, ProjectorEmitter,
                               SpotEmitter)
from ..models.film import Film, ReconstructionFilter
from ..models.instancing import InstancedGroup
from ..models.samplers import IndependentSampler
from ..models.scene import make_scene
from ..models.sdf import SDFGrid
from ..models.sensors import PerspectiveCamera
from ..models.spectra import spectrum_rgb
from ..models.textures import BitmapTexture, ConstantTexture

# named IORs (reference src/render/ior.h, the JAX package's subset)
IOR_NAMES = {
    "air": 1.000277, "water": 1.3330, "acrylic glass": 1.49,
    "bk7": 1.5046, "glass": 1.5046, "sodium chloride": 1.544,
    "amber": 1.55, "sapphire": 1.77, "diamond": 2.419, "vacuum": 1.0,
}

# the plugin types of the JAX package's loader that the port has not yet,
# by the item of ROADMAP.md's Queue 1 that ports them
_ITEMS = {6: "the rest of the plugin set", 7: "volumes and polarization",
          8: "the auxiliary modules"}
UNPORTED = {
    **dict.fromkeys(("thindielectric", "null", "mask", "blendbsdf",
                     "principled", "principledthin", "normalmap", "bumpmap",
                     "pplastic", "hair", "measured"), 6),
    **dict.fromkeys(("polarizer", "retarder", "circular",
                     "measured_polarized"), 7),
    **dict.fromkeys(("checkerboard", "checkerlines", "polarlines", "volume",
                     "mesh_attribute", "comb2d", "star"), 6),
    **dict.fromkeys(("thinlens", "orthographic", "radiancemeter",
                     "irradiancemeter", "radialwarp", "batch", "distant"), 6),
    **dict.fromkeys(("stratified", "multijitter", "ldsampler", "orthogonal",
                     "specfilm", "aov", "moment"), 6),
    **dict.fromkeys(("volpath", "prbvolpath", "volpathmis", "stokes",
                     "homogeneous", "heterogeneous"), 7),
    "blender": 8,
}

BSDF_TYPES = {"diffuse", "conductor", "roughconductor", "dielectric",
              "roughdielectric", "plastic", "roughplastic", "twosided",
              "dispersive_dielectric", "dispersive", "thindielectric",
              "null", "mask", "blendbsdf", "principled", "principledthin",
              "normalmap", "bumpmap", "pplastic", "hair", "measured",
              "measured_polarized", "polarizer", "retarder", "circular"}
SHAPE_TYPES = {"rectangle", "cube", "sphere", "disk", "cylinder", "obj",
               "ply", "mesh", "linearcurve", "bsplinecurve", "serialized",
               "blender"}
EMITTER_TYPES = {"area", "point", "constant", "directional", "envmap", "spot",
                 "directionalarea", "projector"}
SENSOR_TYPES = {"perspective", "thinlens", "orthographic", "radiancemeter",
                "irradiancemeter", "radialwarp", "realisticlens", "batch",
                "distant"}
INTEGRATOR_TYPES = {"path", "direct", "depth", "prb", "prb_basic", "aov",
                    "moment", "ptracer", "volpath", "prbvolpath",
                    "prb_projective", "direct_projective", "volpathmis",
                    "stokes"}
_FILTERS = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")
_SPECTRA = ("uniform", "spectrum", "d65", "blackbody", "regular",
            "irregular")


def not_ported(kind, t):
    """The NotImplementedError for a plugin type the port has not yet."""
    item = UNPORTED[t]
    return NotImplementedError(
        f"{kind} type {t!r} is not ported yet (ROADMAP.md, Queue 1, item "
        f"{item}: {_ITEMS[item]})")


def _check(kind, t):
    if t in UNPORTED:
        raise not_ported(kind, t)


def _spectrum(val, default=None):
    """A color or spectrum property -> (3,) float32 numpy, or
    ``default``."""
    if val is None:
        return None if default is None else np.asarray(default, np.float32)
    if isinstance(val, dict):
        t = val["type"]
        if t in ("rgb", "srgb"):
            return np.broadcast_to(np.asarray(val["value"], np.float32),
                                   (3,)).copy()
        if t in ("uniform", "spectrum"):
            return np.full(3, float(val.get("value", 1.0)), np.float32)
        return spectrum_rgb(val)
    return np.broadcast_to(np.asarray(val, np.float32), (3,)).copy()


def _ior(val, default):
    if val is None:
        return float(default)
    if isinstance(val, str):
        return IOR_NAMES[val.lower()]
    return float(val)


def _eta(d, int_default):
    return _ior(d.get("int_ior"), int_default) / _ior(d.get("ext_ior"),
                                                      1.000277)


def _depth(d, default=6):
    """integrator.h: max_depth -1 is unlimited, russian roulette bounded;
    the loop takes 64, as the JAX package's."""
    v = int(d.get("max_depth", default))
    return 64 if v < 0 else v


class _Plugins:
    """The plugins of one scene dict, made on one device."""

    def __init__(self, device):
        self.device = device

    def vec(self, x):
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def scalar(self, x):
        return torch.tensor(float(x), device=self.device)

    def texture(self, val, default):
        """A texture property: a bitmap (from data or a file) or a
        constant."""
        if isinstance(val, dict) and val.get("type") not in (
                ("rgb", "srgb") + _SPECTRA):
            t = val["type"]
            _check("texture", t)
            if t != "bitmap":
                raise ValueError(f"unsupported texture type {t!r}")
            if val.get("mipmap", False):
                raise NotImplementedError(
                    "mip-mapped bitmaps are not ported yet (ROADMAP.md, "
                    "Queue 1, item 6: the rest of the plugin set)")
            if "data" in val:
                data = np.asarray(val["data"], np.float32)
            else:
                from .bitmap import read_image

                data = np.asarray(read_image(val["filename"]), np.float32)
            if data.ndim == 2:
                data = data[..., None]
            return BitmapTexture(
                data=self.vec(data),
                filter_nearest=val.get("filter_type") == "nearest")
        return ConstantTexture(self.vec(_spectrum(val, default)))

    # ------------------------------------------------------------- BSDFs

    def bsdf(self, d):
        t = d["type"]
        _check("BSDF", t)
        if t == "diffuse":
            return SmoothDiffuse(reflectance=self.texture(
                d.get("reflectance"), [0.5, 0.5, 0.5]))
        if t in ("conductor", "roughconductor"):
            eta, k = CONDUCTOR_IOR.get(d.get("material", "none"),
                                       CONDUCTOR_IOR["none"])
            eta = _spectrum(d["eta"]) if "eta" in d else eta
            k = _spectrum(d["k"]) if "k" in d else k
            if t == "roughconductor":
                return RoughConductor(eta=self.vec(eta), k=self.vec(k),
                                      alpha=self.scalar(d.get("alpha", 0.1)))
            spec = d.get("specular_reflectance")
            return SmoothConductor(
                eta=self.vec(eta), k=self.vec(k),
                specular_reflectance=None if spec is None
                else self.texture(spec, 1.0))
        if t == "dielectric":
            return SmoothDielectric(eta=self.scalar(_eta(d, 1.5046)))
        if t == "roughdielectric":
            return RoughDielectric(eta=self.scalar(_eta(d, 1.5046)),
                                   alpha=self.scalar(d.get("alpha", 0.1)))
        if t in ("plastic", "roughplastic"):
            kw = dict(diffuse_reflectance=self.texture(
                d.get("diffuse_reflectance"), [0.5, 0.5, 0.5]),
                eta=self.scalar(_eta(d, 1.49)),
                nonlinear=bool(d.get("nonlinear", False)))
            if t == "plastic":
                return SmoothPlastic(**kw)
            return RoughPlastic(alpha=self.scalar(d.get("alpha", 0.1)), **kw)
        if t == "twosided":
            return TwoSided(nested=self.bsdf(d["bsdf"]))
        if t in ("dispersive_dielectric", "dispersive"):
            return DispersiveDielectric(
                int_ior_d=self.scalar(d.get("int_ior", 1.5046)),
                int_V_d=self.scalar(d.get("int_V_d", 64.17)),
                ext_ior_d=self.scalar(d.get("ext_ior", 1.000277)),
                ext_V_d=self.scalar(d.get("ext_V_d", 0.0)))
        raise ValueError(f"unsupported bsdf plugin {t!r}")

    # ------------------------------------------------------------ shapes

    def mesh(self, d, bsdf_index, emitter_index):
        t = d["type"]
        _check("shape", t)
        w = d.get("to_world")
        w = None if w is None else np.asarray(w, np.float32)
        if t == "rectangle":
            geo = shp.rectangle(w)
        elif t == "cube":
            geo = shp.cube(w)
        elif t == "disk":
            geo = shp.disk_mesh(to_world=w)
        elif t == "cylinder":
            geo = shp.cylinder_mesh(
                n_seg=int(d.get("n_seg", 32)), p0=d.get("p0", [0, 0, 0]),
                p1=d.get("p1", [0, 0, 1]), radius=float(d.get("radius", 1.0)),
                to_world=w, capped=bool(d.get("capped", False)))
        elif t == "sphere":
            if w is None and ("center" in d or "radius" in d):
                w = tf.compose(tf.translate(np.asarray(
                    d.get("center", [0, 0, 0]), np.float32)),
                    tf.scale(float(d.get("radius", 1.0))))
            geo = shp.sphere_mesh(int(d.get("subdiv", 4)), w)
        elif t in ("obj", "ply", "serialized"):
            from .mesh_io import load_mesh_file, load_serialized

            v, f, n, uv = (load_serialized(d["filename"],
                                           int(d.get("shape_index", 0)))
                           if t == "serialized"
                           else load_mesh_file(d["filename"]))
            if w is not None:
                v, f, n_w, _ = shp._apply_to_world(
                    v, f, n if n is not None else np.zeros_like(v),
                    None, w)
                n = None if n is None else n_w
            geo = (v, f, n, uv)
        elif t == "linearcurve":
            geo = shp.linear_curve_mesh(
                np.asarray(d["control_points"], np.float32),
                np.asarray(d.get("radius", 0.05), np.float32),
                n_seg=int(d.get("n_seg", 8)), to_world=w)
        elif t == "bsplinecurve":
            geo = shp.bspline_curve_mesh(
                np.asarray(d["control_points"], np.float32),
                np.asarray(d.get("radius", 0.05), np.float32),
                n_seg=int(d.get("n_seg", 8)), subdiv=int(d.get("subdiv", 4)),
                to_world=w)
        elif t == "mesh":
            geo = (d["vertices"], d["faces"], d.get("normals"), d.get("uvs"))
        else:
            raise ValueError(f"unsupported shape plugin {t!r}")
        v, f, n, uv = geo
        if d.get("face_normals", False):
            n = None
        return shp.Mesh.make(v, f, normals=n, uvs=uv, device=self.device,
                             bsdf_index=bsdf_index,
                             emitter_index=emitter_index, id=d.get("id", t))

    # ---------------------------------------------------------- emitters

    def shape_emitter(self, e):
        t = e["type"]
        if t not in ("area", "directionalarea"):
            raise ValueError(f"unsupported shape emitter {t!r}")
        kind = AreaEmitter if t == "area" else DirectionalAreaEmitter
        return kind(radiance=self.texture(e.get("radiance"), [1.0, 1.0, 1.0]),
                    sampling_weight=float(e.get("sampling_weight", 1.0)))

    def emitter(self, d):
        t = d["type"]
        ones = [1.0, 1.0, 1.0]
        if t == "point":
            e = PointEmitter(
                intensity=self.vec(_spectrum(d.get("intensity"), ones)),
                position=self.vec(d.get("position", [0, 0, 0])))
        elif t == "constant":
            e = ConstantEmitter(radiance=self.vec(_spectrum(d.get("radiance"),
                                                            ones)))
        elif t == "directional":
            e = DirectionalEmitter(
                irradiance=self.vec(_spectrum(d.get("irradiance"), ones)),
                direction=self.vec(d["direction"]))
        elif t == "envmap":
            if "data" in d:
                data = np.asarray(d["data"], np.float32)
            else:
                from .bitmap import read_image

                data = read_image(d["filename"])
            w = d.get("to_world")
            e = EnvmapEmitter.create(
                data, scale=float(d.get("scale", 1.0)),
                to_world=None if w is None else np.asarray(w, np.float32),
                device=self.device)
        elif t in ("spot", "projector"):
            if "to_world" in d:
                m = np.asarray(d["to_world"], np.float32)
                pos, axis, up = m[:3, 3], m[:3, 2], m[:3, 1]
            else:
                pos = d.get("position", [0, 0, 0])
                axis = d.get("direction", [0, 0, 1])
                up = d.get("up", [0, 1, 0])
            if t == "spot":
                cutoff = float(d.get("cutoff_angle", 20.0))
                e = SpotEmitter(
                    intensity=self.vec(_spectrum(d.get("intensity"), ones)),
                    position=self.vec(pos), direction=self.vec(axis),
                    cutoff_angle=cutoff,
                    beam_width=float(d.get("beam_width", 0.75 * cutoff)))
            else:
                e = ProjectorEmitter(
                    irradiance=self.texture(d.get("irradiance"), ones),
                    position=self.vec(pos), direction=self.vec(axis),
                    up=self.vec(up), scale=self.scalar(d.get("scale", 1.0)),
                    fov=float(d.get("fov", 45.0)))
        else:
            raise ValueError(f"unsupported emitter plugin {t!r}")
        if "sampling_weight" in d:
            e = dataclasses.replace(e, sampling_weight=float(
                d["sampling_weight"]))
        return e

    # ------------------------------------------------------------ sensor

    def film(self, d):
        d = d or {}
        _check("film", d.get("type", "hdrfilm"))
        rf = (d.get("rfilter") or {}).get("type", "gaussian")
        if rf not in _FILTERS:
            raise ValueError(f"unsupported rfilter plugin {rf!r}")
        return Film(width=int(d.get("width", 256)),
                    height=int(d.get("height", 256)),
                    rfilter=getattr(ReconstructionFilter, rf)())

    def sampler(self, d):
        d = d or {}
        t = d.get("type", "independent")
        _check("sampler", t)
        if t != "independent":
            raise ValueError(f"unsupported sampler plugin {t!r}")
        return IndependentSampler(sample_count=int(d.get("sample_count", 16)))

    def sensor(self, d):
        t = d["type"]
        _check("sensor", t)
        film, sampler = self.film(d.get("film")), self.sampler(d.get("sampler"))
        w = d.get("to_world")
        to_world = np.asarray(w if w is not None else np.eye(4), np.float32)
        if t == "realisticlens":
            from ..lens.camera import make_lens_camera

            return make_lens_camera(
                lens_design=d.get("lens_design", "singlet"),
                to_world=None if w is None else to_world, film=film,
                sampler=sampler,
                diagonal=0.001 * float(d.get("diagonal_mm", 35.0)),
                focus_distance=float(d.get("object_distance", 6.0)),
                sample_exit_pupil=bool(d.get("sample_exit_pupil", False)),
                spectral=bool(d.get("spectral", False)),
                near_clip=float(d.get("near_clip", 1e-2)),
                far_clip=float(d.get("far_clip", 1e4)), device=self.device,
                object_distance=float(d.get("object_distance", 6.0)),
                lens_focal_length=float(d.get("lens_focal_length", 0.05)),
                lens_diameter=float(d.get("lens_diameter", 0.01)),
                ap_size=float(d.get("ap_size", 1.0)),
                ap_offset=float(d.get("ap_offset", 2.0)))
        if t != "perspective":
            raise ValueError(f"unsupported sensor plugin {t!r}")
        if "animation" in d or d.get("spectral", False):
            raise NotImplementedError(
                "an animated or spectral perspective camera is not ported "
                "yet (ROADMAP.md, Queue 1, item 6: the rest of the plugin "
                "set)")
        return PerspectiveCamera(
            to_world=self.vec(to_world), film=film, sampler=sampler,
            fov=float(d.get("fov", 39.3077)), fov_axis=d.get("fov_axis", "x"),
            near_clip=float(d.get("near_clip", 1e-2)),
            far_clip=float(d.get("far_clip", 1e4)))


def make_integrator(d):
    """The port's integrator of an integrator dict."""
    from ..models import integrators as it
    from ..models.integrators.projective import (DirectProjectiveIntegrator,
                                                 PathProjectiveIntegrator)

    t = d["type"]
    _check("integrator", t)
    depth = _depth(d)
    if t == "path":
        return it.PathIntegrator(
            max_depth=depth, rr_depth=int(d.get("rr_depth", 5)),
            hide_emitters=bool(d.get("hide_emitters", False)),
            ray_diffs=bool(d.get("ray_diffs", False)),
            timeout=float(d.get("timeout", 0.0)))
    if t == "direct":
        return it.DirectIntegrator(
            emitter_samples=int(d.get("emitter_samples",
                                      d.get("shading_samples", 1))),
            bsdf_samples=int(d.get("bsdf_samples",
                                   d.get("shading_samples", 1))))
    if t == "depth":
        return it.DepthIntegrator()
    if t == "prb":
        return it.PRBIntegrator(max_depth=depth,
                                rr_depth=int(d.get("rr_depth", 5)))
    if t == "prb_basic":
        return it.PRBBasicIntegrator(
            max_depth=depth, hide_emitters=bool(d.get("hide_emitters",
                                                      False)))
    if t == "ptracer":
        return it.ParticleTracerIntegrator(
            max_depth=_depth(d, 8), rr_depth=int(d.get("rr_depth", 5)),
            hide_emitters=bool(d.get("hide_emitters", False)),
            spectral=bool(d.get("spectral", False)))
    if t == "prb_projective":
        return PathProjectiveIntegrator(
            max_depth=depth, rr_depth=int(d.get("rr_depth", 5)),
            sppp=int(d.get("sppp", 4096)), guiding=d.get("guiding", "grid"))
    if t == "direct_projective":
        return DirectProjectiveIntegrator(sppp=int(d.get("sppp", 4096)),
                                          guiding=d.get("guiding", "grid"))
    raise ValueError(f"unsupported integrator plugin {t!r}")


def load_dict(scene_dict: dict, device=None):
    """A Scene from a Mitsuba-style dict (``mi.load_dict``) on ``device``
    (default: the GPU): named BSDFs and refs, shapes with an inline BSDF
    and emitter, standalone emitters, one sensor with its film and
    sampler, one integrator (the scene's own)."""
    if scene_dict.get("type", "scene") != "scene":
        raise ValueError("load_dict takes a dict of type 'scene'")
    device = resolve_device(device)
    b = _Plugins(device)
    named, bsdfs, emitters, meshes, prims = {}, [], [], [], []
    shapegroups, instance_uses = {}, {}
    sensor = integrator = sdf = None

    def bsdf_index(v):
        """The index of an inline BSDF dict or a ref (the default diffuse
        for none)."""
        if v is None:
            if "__default__" not in named:
                named["__default__"] = len(bsdfs)
                bsdfs.append(SmoothDiffuse(reflectance=ConstantTexture(
                    b.vec([0.5, 0.5, 0.5]))))
            return named["__default__"]
        if v.get("type") == "ref":
            return named[v["id"]]
        bsdfs.append(b.bsdf(v))
        return len(bsdfs) - 1

    # pass 1: named BSDFs, which refs name (the reference instantiates
    # bottom up)
    for key, val in scene_dict.items():
        if isinstance(val, dict) and val.get("type") in BSDF_TYPES:
            named[key] = len(bsdfs)
            bsdfs.append(b.bsdf(val))

    for key, val in scene_dict.items():
        if not isinstance(val, dict) or "type" not in val:
            continue
        t = val["type"]
        if t in BSDF_TYPES:
            continue
        if t in SHAPE_TYPES:
            _check("shape", t)
            em_idx = -1
            if "emitter" in val:
                em_idx = len(emitters)
                emitters.append(b.shape_emitter(val["emitter"]))
            b_idx = bsdf_index(val.get("bsdf"))
            if isinstance(val.get("interior"), dict):
                raise not_ported("medium", val["interior"]["type"])
            val = dict(val, id=val.get("id", key))
            if val.get("analytic", False):
                p = analytic_prim(val, b_idx, em_idx)
                prims.extend(p if isinstance(p, list) else [p])
            else:
                meshes.append(b.mesh(val, b_idx, em_idx))
        elif t in EMITTER_TYPES:
            emitters.append(b.emitter(val))
        elif t == "merge":
            # merge.cpp: the children that share a BSDF fused into one mesh
            groups = {}
            for ck, cv in val.items():
                if (not isinstance(cv, dict) or ck in ("type", "id")
                        or cv.get("type") not in SHAPE_TYPES):
                    continue
                bi = bsdf_index(cv.get("bsdf"))
                groups.setdefault(bi, []).append(
                    b.mesh(dict(cv, id=cv.get("id", ck)), bi, -1))
            for bi, ms in groups.items():
                meshes.append(ms[0] if len(ms) == 1 else
                              _merged(ms, bi, val.get("id", key)
                                      + f"_merged{bi}"))
        elif t == "shapegroup":
            shapegroups[val.get("id", key)] = [
                b.mesh(dict(cv, id=cv.get("id", ck)),
                       bsdf_index(cv.get("bsdf")), -1)
                for ck, cv in val.items()
                if isinstance(cv, dict) and ck not in ("type", "id")]
        elif t == "instance":
            ref = val.get("shapegroup")
            gid = ref["id"] if isinstance(ref, dict) else ref
            w = val.get("to_world")
            instance_uses.setdefault(gid, []).append(
                np.asarray(w if w is not None else np.eye(4), np.float32))
        elif t == "sdfgrid":
            sdf = SDFGrid(values=b.vec(val["data"]),
                          bbox_min=b.vec(val.get("bbox_min", [-1, -1, -1])),
                          bbox_max=b.vec(val.get("bbox_max", [1, 1, 1])),
                          bsdf_index=bsdf_index(val.get("bsdf")),
                          id=val.get("id", key))
        elif t in SENSOR_TYPES:
            sensor = b.sensor(val)
        elif t in INTEGRATOR_TYPES:
            integrator = make_integrator(val)
        elif t in UNPORTED:
            raise not_ported("plugin", t)
        else:
            raise ValueError(f"unknown plugin type {t!r} (key {key!r})")

    if sensor is None:
        sensor = PerspectiveCamera(to_world=torch.eye(4, device=device))
    instances = [InstancedGroup.create(shapegroups[gid], np.stack(mats),
                                       id=gid, device=device)
                 for gid, mats in instance_uses.items()]
    analytic = build_analytic(prims, device=device) if prims else None
    return make_scene(meshes, bsdfs, emitters, sensor, device,
                      analytic=analytic, sdf=sdf, instances=instances,
                      integrator=integrator)


def _merged(ms, bsdf_index, mesh_id):
    """One mesh of the meshes ``ms`` (merge.cpp)."""
    offs = np.cumsum([0] + [int(m.vertices.shape[0]) for m in ms])

    def cat(name):
        parts = [getattr(m, name) for m in ms]
        return None if any(p is None for p in parts) else torch.cat(parts)

    return shp.Mesh(vertices=cat("vertices"),
                    faces=torch.cat([m.faces + int(offs[i])
                                     for i, m in enumerate(ms)]),
                    normals=cat("normals"), uvs=cat("uvs"), id=mesh_id,
                    bsdf_index=bsdf_index, emitter_index=-1)
