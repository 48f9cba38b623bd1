"""Path-tracing megakernel: the whole bounce loop in one launch
(mitsuba_tpu/ops/pallas/megakernel.py, ``megakernel_trace``).

Each lane walks up to ``max_depth`` bounces: closest hit over every
face, the environment map's radiance along an escaped ray, emitter-hit
MIS, NEE toward the area light or the environment map with a shadow ray,
BSDF sampling and russian roulette.  Sampling replays the JAX package's
stream exactly: the same PCG3D (seed, lane, dim) hash, the same
dimension layout, warps, frame construction and MIS/RR arithmetic, so
per-lane radiance agrees with the JAX kernel to float rounding.

Three pieces live here:

- ``pack_scene``: the 39-column triangle table and 17-column light table
  of the JAX package, column for column, the texture arena of the
  bitmap-textured faces, and the environment map's arena and meta;
- ``megakernel_trace``: the wrapper.  On a CUDA tensor it launches the
  hand-written kernel in ``csrc/megakernel.cu`` (built with nvcc at
  first use) or raises; on a CPU tensor it runs the plain version.  The
  kernel's threads are persistent and regenerate paths: a thread whose
  path ends takes the next unstarted lane from a counter that the
  wrapper allocates; ``launch_config`` reports the grid;
- ``megakernel_trace_plain``: the plain PyTorch version, a transcription
  of the JAX ``_trace_loop``/``_bounce_step`` for this slice's
  specialisation onto (N,) tensors in the same order of operations.

The ported BSDF codes are the TPU kernel's 0 (constant diffuse), 1
(smooth conductor), 2 (smooth dielectric), 3 (GGX rough conductor), 4
(GGX rough dielectric), 5 (bitmap-textured diffuse), 6 (smooth plastic)
and 7 (GGX rough plastic), each also under the two-sided wrapper (+16),
with flat or smooth shading normals, under one area light, a lat-long
environment map, or both; the wrapper raises ``ValueError`` for the
others.  As the TPU kernel specialises on its static ``btypes``, the
kernel has three builds (``lobes_flag``): ``btypes == (0,)`` runs the
diffuse-only body, a subset of codes 0-4 the body with the conductor and
dielectric lobes, any other the body with every ported surface; with an
environment map, the diffuse-only body or the surface body, each in a
build that adds the environment's branches.  ``bounce_step`` is one
bounce of the plain version with the hit queries passed in, so the BVH
kernels' plain versions (ops/megakernel_bvh.py) run the same body.

A textured face reads its texels from the arena: one float32 tensor of
every bitmap, channel-planar (the R plane, then G, then B; a grayscale
bitmap fills all three), whose offset, width, height, filter and wrap
ride the face row.

The environment map has an arena of its own (``env_data``): H x W texels
of four floats (R, G, B and the sampling table's cell, so that a
bilinear tap is one 16-byte load on the card), then the marginal CDF
(H), the row weights (H) and the conditional CDFs (H x W); its 32-float
meta (``ENV_COLS``) holds the rotations, scale, size and selection pmfs.
The TPU kernel reads its NEE candidates from a table made outside it, per
(lane, depth) (megapath.py ``_env_nee_table`` of the JAX package); the
port's kernel draws each from the same (seed, lane, dim) stream itself,
with two binary searches over the CDFs, and ``env_nee_sample`` is the
plain version of that draw.  The TPU kernel's cap on the map's texels
(``MAX_ENV_TEXELS``, a VMEM budget) does not apply: the arena stays in
global memory.

One departure from the TPU kernel: its ``_bounce_step`` marks a sampled
rough-dielectric lobe as a Dirac one (``smooth_lobe`` at
megakernel.py:1539 leaves out ``is_rdiel``), so an emitter hit after it
takes MIS weight 1 while NEE at the same vertex counts that light too.
The port follows the JAX package's ``RoughDielectric.sample``
(``delta`` False) and path integrator instead, so its megakernels and
its wavefront path agree lane by lane.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

import math

from ..core import rng, warp
from ..core import transform as tf
from ..core.distr2d import Marginal2D
from ..core.math import RAY_EPS, coordinate_system, cross, safe_div
from ..models.bsdfs import (RoughConductor, RoughDielectric, RoughPlastic,
                            SmoothConductor, SmoothDielectric, SmoothDiffuse,
                            SmoothPlastic, TwoSided, fdr_fit)
from ..models.emitters import (UV_TO_SOLID_ANGLE, AreaEmitter,
                               EnvmapEmitter, bilinear, uv_to_dir)
from ..models.samplers import IndependentSampler
from ..models.textures import BitmapTexture, ConstantTexture
from . import _build
from .intersect import DET_EPS, tri_test
from .intersect import cross as cross3

MAX_FACES = 1024        # the kernel stages the face table in shared memory
MAX_LIGHT_FACES = 16
INV_PI = warp.INV_PI

# must match models/integrators/common.py dimension layout
DIM_BOUNCE_BASE = 8
DIMS_PER_BOUNCE = 8
SLOT_EM_SELECT = 0
SLOT_EM_POS = 1
SLOT_BSDF_LOBE = 2
SLOT_BSDF_DIR = 3
SLOT_RR = 4

# triangle table columns:
#   0:3 p0, 3:6 e1, 6:9 e2, 9:12 reflectance, 12:15 emission,
#   15 is_light, 16 pdf_area on light faces or GGX alpha, 17 bsdf_type,
#   18:24 type params (conductors: eta, k rgb; dielectrics: eta in 18;
#   plastics: eta, fdr, nonlinear; textured diffuse: arena offset, W, H,
#   nearest, wrap), 24:30 uv0 uv1 uv2, 30:39 n0 n1 n2
TRI_COLS = 39
# BSDF type codes of column 17 (the TPU kernel's); the ported ones
BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC = 0, 1, 2
BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC = 3, 4
BSDF_TEX_DIFFUSE, BSDF_PLASTIC, BSDF_ROUGH_PLASTIC = 5, 6, 7
TWO_SIDED = 16    # the TwoSided wrapper: +16 on the nested BSDF's code
PORTED_BTYPES = frozenset(range(8)) | frozenset(range(16, 24))
_BSDF_CODES = ((SmoothDiffuse, BSDF_DIFFUSE),
               (SmoothConductor, BSDF_CONDUCTOR),
               (SmoothDielectric, BSDF_DIELECTRIC),
               (RoughConductor, BSDF_ROUGH_CONDUCTOR),
               (RoughDielectric, BSDF_ROUGH_DIELECTRIC),
               (SmoothPlastic, BSDF_PLASTIC),
               (RoughPlastic, BSDF_ROUGH_PLASTIC))
# light table columns: 0:3 p0, 3:6 e1, 6:9 e2, 9:12 n, 12 cdf,
#   13 pdf_area, 14:17 Le
LIGHT_COLS = 17
# environment map meta: 0:9 world -> env rotation (row major), 9 scale,
#   10 W, 11 H, 12 texel offset (0: the texels lead the env arena), 13 CDF
#   offset, 14 the sampling table's total, 15 env selection pmf, 16 area
#   selection pmf (the TPU kernel's columns); 17:26 env -> world rotation
#   (row major), 26 the NEE sample's distance 2R
ENV_COLS = 32
ENV_TEXEL = 4     # floats a texel in the env arena: R, G, B, table cell


# ------------------------------------------------------------ scene packing

def bsdf_code(b) -> int | None:
    """The kernel's type code of BSDF ``b``, None outside the ported
    subset (_plugin_subset_ok of the JAX package): constant or bitmap
    (H, W, 1 | 3) diffuse, the conductors and dielectrics without a
    specular_reflectance or specular_transmittance texture, the plastics
    over a constant diffuse_reflectance, and ``TwoSided`` over any of
    these but a dielectric (+16)."""
    if type(b) is TwoSided:
        if isinstance(b.nested, (SmoothDielectric, RoughDielectric)):
            return None
        code = _nested_code(b.nested)
        return None if code is None else code + TWO_SIDED
    return _nested_code(b)


def _nested_code(b):
    code = next((c for cls, c in _BSDF_CODES if type(b) is cls), None)
    if code == BSDF_DIFFUSE:
        r = b.reflectance
        if isinstance(r, ConstantTexture):
            return code
        if isinstance(r, BitmapTexture) and r.data.dim() == 3 \
                and int(r.data.shape[2]) in (1, 3):
            return BSDF_TEX_DIFFUSE
        return None
    if code in (BSDF_PLASTIC, BSDF_ROUGH_PLASTIC):
        return code if isinstance(b.diffuse_reflectance,
                                  ConstantTexture) else None
    if code is not None and (
            getattr(b, "specular_reflectance", None) is not None
            or getattr(b, "specular_transmittance", None) is not None):
        return None
    return code


def scene_btypes(scene) -> tuple:
    """The static ``btypes`` of the scene's kernels (megapath.py:201 of
    the JAX package): the sorted BSDF codes present, 0 always."""
    return tuple(sorted({0} | {bsdf_code(b) for b in scene.bsdfs}))


def plugin_subset_ok(scene) -> bool:
    """True iff the scene's plugins are inside the ported kernels'
    subset (_plugin_subset_ok of the JAX package): BSDFs of a ported code
    (``bsdf_code``); one or two emitters, at most one constant-radiance
    area light of at most MAX_LIGHT_FACES faces and at most one (H, W, 3)
    environment map, each of sampling weight 1; the independent sampler.
    Flat and smooth shading normals are both ported."""
    n_area = n_env = 0
    for i, e in enumerate(scene.emitters):
        if float(e.sampling_weight) != 1.0:
            return False
        if isinstance(e, AreaEmitter):
            s = scene.emitter_shape[i]
            if not (isinstance(e.radiance, ConstantTexture) and s >= 0) \
                    or int(scene.meshes[s].faces.shape[0]) > MAX_LIGHT_FACES:
                return False
            n_area += 1
        elif isinstance(e, EnvmapEmitter) and i == scene.env_index \
                and e.data.dim() == 3 and int(e.data.shape[2]) == 3:
            n_env += 1
        else:
            return False
    if not (1 <= n_area + n_env <= 2 and n_area <= 1 and n_env <= 1):
        return False
    if not isinstance(scene.sensor.sampler, IndependentSampler):
        return False
    return all(bsdf_code(b) is not None for b in scene.bsdfs)


def megakernel_applicable(scene) -> bool:
    """True iff the brute kernel takes the scene: the plugin subset and
    at most MAX_FACES faces in all."""
    return plugin_subset_ok(scene) and \
        sum(int(m.faces.shape[0]) for m in scene.meshes) <= MAX_FACES


def pack_scene(scene):
    """Packed kernel tables (megakernel.py:291 of the JAX package).

    Returns (tris (F, TRI_COLS), light (max(L, 1), LIGHT_COLS), F, L,
    tex, env): ``tex`` is the texture arena, a 1-D float32 tensor of every
    bitmap-textured BSDF's texels in ``scene.bsdfs`` order, each
    channel-planar with a grayscale bitmap broadcast to three planes, or
    None when no face is textured; ``env`` the environment map's keyword
    arguments of the kernel wrappers (``env_data``, ``env_meta``,
    ``env_pos``: ``pack_env``), empty without one.  The NEE pdf of a light
    face is uniform 1/total_light_area in area measure.  Unlike the TPU
    tables, none is padded to a tile.
    """
    v, f, n_all, uv_all, _, _ = scene.geometry()
    dev = v.device
    F = int(f.shape[0])
    # per-face metadata from per-mesh values, filled on the device
    counts = [int(m.faces.shape[0]) for m in scene.meshes]
    offsets = np.cumsum([0] + counts)

    def per_face(values, dtype):
        return torch.cat([torch.full((c,), x, dtype=dtype, device=dev)
                          for c, x in zip(counts, values)])

    area_idx = next((i for i, e in enumerate(scene.emitters)
                     if isinstance(e, AreaEmitter)), -1)
    light_mesh = [area_idx >= 0 and e == area_idx for e in scene.shape_emitter]
    light_faces = torch.cat([
        torch.arange(int(offsets[s]), int(offsets[s + 1]), device=dev)
        for s in range(len(counts)) if light_mesh[s]]
        + [torch.zeros(0, dtype=torch.int64, device=dev)])
    L = int(light_faces.shape[0])

    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0

    # per-BSDF rows [refl(3) | type(1) | params(6) | alpha(1)]
    rows, planes = [], []
    for b in scene.bsdfs:
        row, plane = _bsdf_row(b, dev, sum(int(p.numel()) for p in planes))
        rows.append(row)
        if plane is not None:
            planes.append(plane)
    bsdf_tab = torch.stack(rows)
    face_bsdf = bsdf_tab[per_face(scene.shape_bsdf, torch.int64)]
    refl = face_bsdf[:, 0:3]
    btype = face_bsdf[:, 3:4]
    bparams = face_bsdf[:, 4:10]
    alpha_face = face_bsdf[:, 10]
    le = (scene.emitters[area_idx].radiance.value.to(torch.float32).reshape(3)
          if area_idx >= 0 else torch.zeros(3, device=dev))
    is_light = per_face([float(x) for x in light_mesh], torch.float32)
    emission = is_light[:, None] * le[None, :]

    cr = cross(e1[light_faces], e2[light_faces])
    la = 0.5 * torch.sqrt(torch.clamp(torch.sum(cr ** 2, dim=-1), min=1e-30))
    total_la = torch.clamp(torch.sum(la), min=1e-20)
    # col 16: pdf_area on light faces, GGX alpha elsewhere
    pdf_area = torch.where(is_light > 0.5, is_light / total_la, alpha_face)

    uv0, uv1, uv2 = (uv_all[f[:, k]] for k in range(3))
    ngf = cross(e1, e2)
    ngf = ngf / torch.sqrt(torch.clamp(
        torch.sum(ngf * ngf, dim=-1, keepdim=True), min=1e-30))
    smf = per_face([float(m.normals is not None) for m in scene.meshes],
                   torch.float32)[:, None]
    n0, n1, n2 = (torch.where(smf > 0.5, n_all[f[:, k]], ngf) for k in range(3))
    tris = torch.cat([
        p0, e1, e2, refl, emission,
        is_light[:, None], pdf_area[:, None],
        btype, bparams, uv0, uv1, uv2, n0, n1, n2,
    ], dim=1).contiguous()

    ln = cr / torch.sqrt(torch.clamp(torch.sum(cr * cr, -1, keepdim=True),
                                     min=1e-30))
    cdf = torch.cumsum(la, dim=0) / total_la
    inv_a = torch.ones((L, 1), device=dev) / total_la
    light = torch.cat([
        p0[light_faces], e1[light_faces], e2[light_faces], ln,
        cdf[:, None], inv_a, le[None, :].expand(L, 3),
    ], dim=1)
    if L == 0:
        light = torch.zeros((1, LIGHT_COLS), device=dev)
    tex = torch.cat(planes).contiguous() if planes else None
    return tris, light.contiguous(), F, L, tex, pack_env(scene)


def pack_env(scene) -> dict:
    """The environment map's kernel inputs (megakernel.py:456-476 of the
    JAX package, in the port's layout: the module's head): ``env_data``
    the arena, ``env_meta`` the (ENV_COLS,) meta, ``env_pos`` its index
    among the emitters; {} without one."""
    if scene.env_index < 0:
        return {}
    e = scene.emitters[scene.env_index]
    dev = e.data.device
    h, w = int(e.data.shape[0]), int(e.data.shape[1])
    d = e.distr
    texels = torch.cat([e.data, d.pdf_table[..., None]], dim=-1)
    data = torch.cat([texels.reshape(-1), d.row_cdf, d.row_weight,
                      d.cond_cdf.reshape(-1)]).contiguous()
    n_em = len(scene.emitters)
    head = [float(w), float(h), 0.0, float(ENV_TEXEL * h * w)]
    meta = torch.cat([
        tf.inverse(e.to_world)[:3, :3].reshape(-1),
        e.scale.reshape(1).to(torch.float32),
        torch.tensor(head, device=dev), d.total.reshape(1),
        torch.tensor([1.0 / n_em, 1.0 / n_em], device=dev),
        e.to_world[:3, :3].reshape(-1),
        torch.tensor([2.0 * e.scene_radius], device=dev),
        torch.zeros(ENV_COLS - 27, device=dev)]).to(torch.float32)
    return {"env_data": data, "env_meta": meta.contiguous(),
            "env_pos": scene.env_index}


def _bsdf_row(b, dev, tex_off):
    """The 11-float row of BSDF ``b`` (megakernel.py:327-420 of the JAX
    package): reflectance (3), type code, six parameters, GGX alpha; and
    a bitmap's channel-planar texels, which go into the arena at
    ``tex_off``, or None."""
    def f32(x, n):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(n)

    code = bsdf_code(b)
    if code >= TWO_SIDED:
        b = b.nested
    inner = code % TWO_SIDED
    refl = torch.zeros(3, device=dev)
    params = torch.zeros(6, device=dev)
    alpha = torch.zeros(1, device=dev)
    plane = None
    if inner == BSDF_DIFFUSE:
        refl = f32(b.reflectance.value, 3)
    elif inner == BSDF_TEX_DIFFUSE:
        t = b.reflectance
        h, w = int(t.data.shape[0]), int(t.data.shape[1])
        data = t.data.to(device=dev, dtype=torch.float32)
        plane = data.expand(h, w, 3).permute(2, 0, 1).reshape(-1)
        refl = torch.ones(3, device=dev)
        params = f32([float(tex_off), float(w), float(h),
                      float(t.filter_nearest), float(t.wrap_repeat), 0.0], 6)
    elif inner in (BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR):
        params = torch.cat([f32(b.eta, 3), f32(b.k, 3)])
    elif inner in (BSDF_DIELECTRIC, BSDF_ROUGH_DIELECTRIC):
        params[0] = f32(b.eta, 1)[0]
    else:   # the plastics: [eta, fdr, nonlinear]
        refl = f32(b.diffuse_reflectance.value, 3)
        eta = f32(b.eta, 1)
        params = torch.cat([eta, fdr_fit(eta), f32(float(b.nonlinear), 1),
                            torch.zeros(3, device=dev)])
    if inner in (BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
                 BSDF_ROUGH_PLASTIC):
        alpha = f32(b.alpha, 1)
    return torch.cat([refl, f32(float(code), 1), params, alpha]), plane


# --------------------------------------------------------------- the wrapper

def megakernel_trace(tris, light, lane, o, d, active, seed,
                     max_depth: int, rr_depth: int, n_faces: int,
                     n_lights: int, btypes: tuple = (0,), tex=None,
                     env_data=None, env_meta=None, env_pos: int = -1,
                     smooth: bool = False):
    """Per-lane path radiance L (N, 3) for rays (o, d) (N, 3).

    ``tris``/``light``/``tex`` and the environment map's ``env_data``,
    ``env_meta`` and ``env_pos`` come from ``pack_scene`` (``tex``, the
    texture arena, only matters to a textured code, 5 or 21; without an
    environment map the three ``env_`` arguments stay unset); ``lane`` is
    the int32 RNG lane id, ``active`` a bool mask, ``seed`` the render
    seed; ``smooth`` interpolates the shading normal (columns 30:39);
    ``btypes`` is the sorted tuple of the BSDF codes in the table
    (``scene_btypes``).  On a CUDA tensor this launches the kernel (and
    counts the launch in ``megakernel_trace.launches``) or raises; on a
    CPU tensor it runs ``megakernel_trace_plain``.
    """
    btypes = check_variant(btypes, tex, env_data, env_meta, env_pos)
    if not 0 <= n_faces <= MAX_FACES or not 0 <= n_lights <= MAX_LIGHT_FACES:
        raise ValueError(f"{n_faces} faces / {n_lights} light faces exceed "
                         f"the kernel's {MAX_FACES} / {MAX_LIGHT_FACES}")
    env = env_args(env_data, env_meta, env_pos)
    if o.device.type == "cpu":
        return megakernel_trace_plain(tris, light, lane, o, d, active, seed,
                                      max_depth, rr_depth, n_faces, n_lights,
                                      smooth, btypes=btypes, tex=tex, **env)
    return _trace_cuda(tris, light, lane, o, d, active, seed,
                       max_depth, rr_depth, n_faces, n_lights, smooth,
                       btypes, tex, env)


megakernel_trace.launches = 0


def check_variant(btypes, tex=None, env_data=None, env_meta=None,
                  env_pos=-1):
    """Raise ValueError for a kernel variant that is not ported, a
    textured code without a texture arena, or an environment map whose
    arena, meta and position do not go together (all three or none);
    returns ``btypes`` as a tuple."""
    btypes = tuple(btypes)
    if not btypes or not set(btypes) <= PORTED_BTYPES:
        raise ValueError(f"BSDF types {btypes} are not ported; only codes "
                         "0-7 and 16-23 are (diffuse, textured diffuse, "
                         "conductors, dielectrics and plastics, each also "
                         "two-sided)")
    if (env_data is None) != (env_meta is None) \
            or (env_data is None) != (env_pos < 0):
        raise ValueError("an environment map needs its arena, meta and "
                         "position (pack_scene's env), all three")
    if env_meta is not None:
        if env_meta.shape != (ENV_COLS,) or env_pos not in (0, 1):
            raise ValueError(f"env_meta must hold {ENV_COLS} floats and "
                             "env_pos be 0 or 1 (of at most two emitters)")
        w, h = int(env_meta[10]), int(env_meta[11])
        if env_data.dim() != 1 or env_data.numel() != h * (
                (ENV_TEXEL + 1) * w + 2) or w < 1 or h < 1:
            raise ValueError(f"env_data must be the {h} x {w} map's arena "
                             "(pack_env)")
    if textured(btypes) and (tex is None or tex.numel() == 0):
        raise ValueError(f"BSDF types {btypes} hold a textured diffuse, "
                         "which needs the texture arena (pack_scene's tex)")
    return btypes


def textured(btypes) -> bool:
    """True iff ``btypes`` holds a bitmap-textured diffuse (5 or 21)."""
    return any(b % TWO_SIDED == BSDF_TEX_DIFFUSE for b in btypes)


def lobes_flag(btypes, env: bool = False) -> int:
    """Which build of a path kernel runs ``btypes`` (csrc/path_common.cuh
    DIFFUSE_BUILD, LOBE_BUILD, SURFACE_BUILD): 0 the diffuse-only body for
    (0,), 1 the conductor and dielectric lobes for a subset of codes 0-4,
    2 every ported surface.  With an environment map (``env``) the lobe
    set goes to the surface build, which the environment's builds share
    with the diffuse-only one."""
    btypes = tuple(btypes)
    if btypes == (0,):
        return 0
    return 1 if set(btypes) <= set(range(5)) and not env else 2


def env_args(env_data=None, env_meta=None, env_pos=-1) -> dict:
    """The environment map's keyword arguments for the plain versions,
    {} without one."""
    if env_data is None:
        return {}
    return {"env_data": env_data, "env_meta": env_meta, "env_pos": env_pos}


def env_ptrs(env: dict, device):
    """(arena pointer, arena floats, meta as 32 C floats, position) of the
    environment map for a C entry: a null pointer, 0, zeros and -1
    without one."""
    meta = (ctypes.c_float * ENV_COLS)()
    if not env:
        return None, 0, meta, -1
    check_tensor("env_data", env["env_data"], torch.float32, (None,), device)
    if env["env_data"].data_ptr() % 16:
        raise ValueError("env_data must be 16-byte aligned")
    meta[:] = [float(x) for x in env["env_meta"].cpu()]
    return (env["env_data"].data_ptr(), int(env["env_data"].numel()), meta,
            int(env["env_pos"]))


def check_tensor(name, x, dtype, shape, device):
    if x.dtype != dtype or x.device != device or not x.is_contiguous() \
            or x.dim() != len(shape) \
            or any(s is not None and s != xs for s, xs in zip(shape, x.shape)):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def tex_args(tex, device):
    """(pointer, length) of the texture arena for a C entry: a null
    pointer and 0 without one."""
    if tex is None:
        return None, 0
    check_tensor("tex", tex, torch.float32, (None,), device)
    return tex.data_ptr(), int(tex.numel())


def _library():
    lib = _build.load("megakernel")
    if lib.megakernel_trace.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.megakernel_trace.argtypes = [p, i, p, i, p, i, p, i, p, i, p, p,
                                         p, p, ctypes.c_uint32, i, i, i, i,
                                         i, p, p, p]
        lib.megakernel_trace.restype = i
        lib.megakernel_trace_config.argtypes = [i, i, i, i, i, p]
        lib.megakernel_trace_config.restype = i
    return lib


def launch_config(n_faces: int, n_lights: int, n: int,
                  btypes: tuple = (0,), env: bool = False) -> dict:
    """The persistent grid of a launch over ``n`` lanes on the current
    CUDA device (with an environment map: ``env``): blocks, resident
    blocks per SM (the occupancy calculator's), threads a block, SMs."""
    cfg = (ctypes.c_int * 4)()
    rc = _library().megakernel_trace_config(n_faces, n_lights, n,
                                            lobes_flag(btypes, env),
                                            int(env), cfg)
    if rc != 0:
        raise RuntimeError(f"megakernel_trace_config: CUDA error {rc}")
    return {"blocks": cfg[0], "resident_per_sm": cfg[1], "threads": cfg[2],
            "sms": cfg[3]}


def _trace_cuda(tris, light, lane, o, d, active, seed, max_depth, rr_depth,
                n_faces, n_lights, smooth, btypes, tex, env):
    dev = o.device
    n = int(o.shape[0])
    check_tensor("tris", tris, torch.float32, (None, TRI_COLS), dev)
    check_tensor("light", light, torch.float32, (None, LIGHT_COLS), dev)
    check_tensor("lane", lane, torch.int32, (n,), dev)
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    tex_ptr, n_tex = tex_args(tex, dev)
    env_ptr, n_env, meta, env_pos = env_ptrs(env, dev)
    if tris.shape[0] < n_faces or light.shape[0] < n_lights:
        raise ValueError("tables are shorter than n_faces / n_lights")
    fn = _library().megakernel_trace
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    next_slot = torch.zeros(1, dtype=torch.int32, device=dev)  # the schedule
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(tris.data_ptr(), n_faces, light.data_ptr(), n_lights,
                tex_ptr, n_tex, env_ptr, n_env, ctypes.addressof(meta),
                env_pos, lane.data_ptr(), o.data_ptr(), d.data_ptr(),
                active.data_ptr(), int(seed) & rng.MASK32, max_depth,
                rr_depth, int(smooth), lobes_flag(btypes, bool(env)), n,
                out.data_ptr(), next_slot.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel_trace launch failed: CUDA error {rc}")
    megakernel_trace.launches += 1
    return out


# --------------------------------------------------------- the plain version

def _normalize3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


def _mis(pa, pb):
    """Power heuristic (common.py mis_weight)."""
    a2 = pa * pa
    w = a2 / torch.clamp(a2 + pb * pb, min=1e-32)
    return torch.where(pa > 0.0, w, 0.0)


def _brute_queries(tri, counts):
    """(closest, anyhit) over every face of ``tri`` (rows of Python
    floats), with the tie rule and early exit of csrc/megakernel.cu."""
    n_faces = len(tri)

    def closest(ox, oy, oz, dx, dy, dz, act):
        """(best t, best face or -1); strict ``<`` keeps the LOWEST index
        among equal t."""
        if counts is not None:
            counts["closest_tests"] += int(act.sum()) * n_faces
        bt = torch.full_like(ox, float("inf"))
        bj = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
        for j, c in enumerate(tri):
            hit, t = tri_test(*c[:9], ox, oy, oz, dx, dy, dz, bt)
            win = hit & (t < bt)
            bt = torch.where(win, t, bt)
            bj = torch.where(win, j, bj)
        return bt, bj

    def anyhit(ox, oy, oz, dx, dy, dz, maxt, act):
        """Occluded within maxt; a shadow ray stops at its first
        occluder, which is what ``counts`` records for the lanes in act."""
        occ = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
        first = torch.full(ox.shape, n_faces, dtype=torch.int64,
                           device=ox.device)
        for j, c in enumerate(tri):
            hit, _ = tri_test(*c[:9], ox, oy, oz, dx, dy, dz, maxt)
            first = torch.where(hit & ~occ, j, first)
            occ = occ | hit
        if counts is not None:
            tests = torch.where(occ, first + 1, n_faces)
            counts["shadow_tests"] += int(tests[act].sum())
        return occ

    return closest, anyhit


def initial_state(o, d, active):
    """The 16-tuple path state of primary rays: o(3), d(3), L(3) = 0,
    throughput(3) = 1, eta_acc = 1, prev_pdf = 1, prev_delta, act."""
    ones = torch.ones_like(o[:, 0])
    zeros = torch.zeros_like(ones)
    return (*o.unbind(-1), *d.unbind(-1), zeros, zeros, zeros,
            ones, ones, ones, ones, ones,
            torch.ones_like(active, dtype=torch.bool), active.to(torch.bool))


def megakernel_trace_plain(tris, light, lane, o, d, active, seed,
                           max_depth: int, rr_depth: int, n_faces: int,
                           n_lights: int, smooth: bool = False,
                           counts: dict | None = None, btypes: tuple = (0,),
                           tex=None, env_data=None, env_meta=None,
                           env_pos: int = -1):
    """Plain PyTorch version of the kernel, on any device.

    When ``counts`` is a dict it receives the work the kernel does on
    these inputs: ``closest_tests`` (ray-triangle tests of the closest-hit
    sweeps, every face for each lane still active at a bounce),
    ``shadow_tests`` (tests of the shadow rays, which stop at their first
    occluder) and, for a textured code, ``tex_floats`` (the arena floats
    read at textured hits: three channels of one texel, nearest, or of
    four, bilinear); with an environment map ``env_floats`` (the env
    arena's floats read: four texels at an escape and at an envmap NEE
    sample, one table cell, and the steps of its two binary searches).
    """
    if counts is not None:
        counts.setdefault("closest_tests", 0)
        counts.setdefault("shadow_tests", 0)
    closest, anyhit = _brute_queries(tris[:n_faces].tolist(), counts)
    state = initial_state(o, d, active)
    env = env_view(env_data, env_meta, env_pos)
    for depth in range(max_depth):
        state = bounce_step(tris, closest, anyhit, light, n_lights, depth,
                            max_depth, rr_depth, rng.as_u32(lane), seed,
                            state, smooth, btypes, tex, counts, env)
    return torch.stack(state[6:9], dim=-1)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _safe_div(a, b, eps=1e-20):
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _rsqrt_safe(x, eps=1e-20):
    return torch.where(x > eps, 1.0 / torch.sqrt(torch.clamp(x, min=eps)), 0.0)


def _ggx_g1(wx, wy, wz, mx, my, mz, a):
    """Smith masking of GGX, one lane a value (microfacet.smith_g1)."""
    c2 = wz * wz
    a2 = (wx * a) * (wx * a) + (wy * a) * (wy * a)
    lam = 0.5 * (_safe_sqrt(1.0 + _safe_div(a2, c2)) - 1.0)
    g = 1.0 / (1.0 + lam)
    back = ((wx * mx + wy * my + wz * mz) * wz) <= 0.0
    return torch.where(back, 0.0, g)


def _ggx_d(mx, my, mz, a):
    t = (mx / a) * (mx / a) + (my / a) * (my / a) + mz * mz
    d = _safe_div(torch.ones_like(t), math.pi * a * a * (t * t))
    return torch.where(mz > 0.0, d, 0.0)


def _vndf_pdf(wix, wiy, wiz, mx, my, mz, a):
    g1 = _ggx_g1(wix, wiy, wiz, mx, my, mz, a)
    return _safe_div(g1 * torch.abs(wix * mx + wiy * my + wiz * mz)
                     * _ggx_d(mx, my, mz, a), torch.abs(wiz))


def _fr_cond(c, e, k):
    """Conductor Fresnel, one channel (core/fresnel.py)."""
    c2 = c * c
    s2 = 1.0 - c2
    e2 = e * e
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = _safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = _safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * torch.abs(c)
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def _fr_diel(ci, eta):
    """Dielectric Fresnel of the signed cosine ``ci`` (core/fresnel.py):
    (F, cos_theta_t, eta_it, eta_ti)."""
    outside = ci >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    cti = torch.abs(ci)
    sin2_t = (eta_ti * eta_ti) * torch.clamp(1.0 - cti * cti, min=0.0)
    tir = sin2_t >= 1.0
    ctt = _safe_sqrt(1.0 - sin2_t)
    rs = (cti - eta_it * ctt) / torch.clamp(cti + eta_it * ctt, min=1e-20)
    rp = (eta_it * cti - ctt) / torch.clamp(eta_it * cti + ctt, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    f = torch.where(tir, 1.0, f)
    f = torch.where(torch.abs(eta - 1.0) < 1e-6, 0.0, f)
    cos_t = torch.where(tir, 0.0, -torch.sign(ci) * ctt)
    return f, cos_t, eta_it, eta_ti


def _vndf_sample(wix, wiy, wiz, u1, u2, a):
    """Heitz 2018 visible-normal sample (microfacet.sample_vndf,
    isotropic)."""
    hx, hy, hz = a * wix, a * wiy, wiz
    inv = _rsqrt_safe(hx * hx + hy * hy + hz * hz)
    vhx, vhy, vhz = hx * inv, hy * inv, hz * inv
    lensq = vhx * vhx + vhy * vhy
    inv2 = _safe_div(torch.ones_like(lensq), _safe_sqrt(lensq))
    ok = lensq > 1e-12
    t1x = torch.where(ok, -vhy * inv2, 1.0)
    t1y = torch.where(ok, vhx * inv2, 0.0)
    t1z = torch.zeros_like(t1x)
    t2x, t2y, t2z = cross3(vhx, vhy, vhz, t1x, t1y, t1z)
    r = _safe_sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * _safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = _safe_sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nhx = p1 * t1x + p2 * t2x + p3 * vhx
    nhy = p1 * t1y + p2 * t2y + p3 * vhy
    nhz = p1 * t1z + p2 * t2z + p3 * vhz
    mx, my, mz = a * nhx, a * nhy, torch.clamp(nhz, min=1e-6)
    inv3 = _rsqrt_safe(mx * mx + my * my + mz * mz)
    return mx * inv3, my * inv3, mz * inv3


def _nee_rough_conductor(wi, wo, a, C):
    """RoughConductor.eval / pdf toward the light direction ``wo``
    (local): ((f_r, f_g, f_b) x cos, pdf)."""
    wix, wiy, wiz = wi
    wox, woy, woz = wo
    hx, hy, hz = wix + wox, wiy + woy, wiz + woz
    hn = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    hx, hy, hz = hx / hn, hy / hn, hz / hn
    d = _ggx_d(hx, hy, hz, a)
    g2 = (_ggx_g1(wix, wiy, wiz, hx, hy, hz, a)
          * _ggx_g1(wox, woy, woz, hx, hy, hz, a))
    cos_im = wix * hx + wiy * hy + wiz * hz
    scal = d * g2 / torch.clamp(4.0 * wiz, min=1e-20)
    f = tuple(_fr_cond(cos_im, C[c], C[c + 3]) * scal for c in range(3))
    pdf = _vndf_pdf(wix, wiy, wiz, hx, hy, hz, a) / torch.clamp(
        4.0 * torch.abs(wox * hx + woy * hy + woz * hz), min=1e-20)
    return f, pdf


def _nee_rough_dielectric(wi, wo, a, eta_d):
    """RoughDielectric.eval_pdf toward ``wo`` (local, either side):
    (value x |cos|, the same for each channel; pdf)."""
    wix, wiy, wiz = wi
    wox, woy, woz = wo
    refl = wiz * woz > 0.0
    eta_path = torch.where(wiz > 0.0, eta_d, 1.0 / eta_d)
    qx = torch.where(refl, wix + wox, wix + wox * eta_path)
    qy = torch.where(refl, wiy + woy, wiy + woy * eta_path)
    qz = torch.where(refl, wiz + woz, wiz + woz * eta_path)
    n2 = qx * qx + qy * qy + qz * qz
    qinv = torch.where(n2 > 1e-20,
                       1.0 / torch.sqrt(torch.clamp(n2, min=1e-20)), 0.0)
    qx, qy, qz = qx * qinv, qy * qinv, qz * qinv
    sg_m = torch.where(qz >= 0.0, 1.0, -1.0)
    qx, qy, qz = qx * sg_m, qy * sg_m, qz * sg_m
    sg_o = torch.where(wiz >= 0.0, 1.0, -1.0)
    mox, moy, moz = qx * sg_o, qy * sg_o, qz * sg_o
    cim = wix * mox + wiy * moy + wiz * moz
    com = wox * mox + woy * moy + woz * moz
    fD, _, eta_it, eta_ti = _fr_diel(cim, eta_d)
    sgn_i = torch.where(wiz >= 0.0, 1.0, -1.0)
    sgn_o = torch.where(woz >= 0.0, 1.0, -1.0)
    d = _ggx_d(qx, qy, qz, a)
    g2 = (_ggx_g1(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, qx, qy, qz, a)
          * _ggx_g1(wox * sgn_o, woy * sgn_o, woz * sgn_o, qx, qy, qz, a))
    val_r = fD * d * g2 / torch.clamp(4.0 * torch.abs(wiz), min=1e-20)
    den = cim + eta_it * com
    val_t = ((1.0 - fD) * d * g2 * torch.abs(cim * com) * (eta_it * eta_it)
             / torch.clamp(torch.abs(wiz) * den * den, min=1e-20)
             ) * (eta_ti * eta_ti)
    val = torch.where(refl, val_r, torch.abs(val_t))
    pdm = _vndf_pdf(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, qx, qy, qz, a)
    jr = 1.0 / torch.clamp(4.0 * torch.abs(com), min=1e-20)
    jt = torch.abs(com) * (eta_it * eta_it) / torch.clamp(den * den,
                                                          min=1e-20)
    pdf = pdm * torch.where(refl, fD * jr, (1.0 - fD) * jt)
    ok = (torch.abs(wiz) > 1e-6) & (n2 > 1e-20) & (refl | (cim * com < 0.0))
    return torch.where(ok, val, 0.0), torch.where(ok, pdf, 0.0)


def _sample_rough_conductor(wi, u1, u2, a, C):
    """RoughConductor.sample: (local wo, (w_r, w_g, w_b), pdf)."""
    wix, wiy, wiz = wi
    mx, my, mz = _vndf_sample(wix, wiy, wiz, u1, u2, a)
    cim = wix * mx + wiy * my + wiz * mz
    rx = 2.0 * cim * mx - wix
    ry = 2.0 * cim * my - wiy
    rz = 2.0 * cim * mz - wiz
    pdf = _vndf_pdf(wix, wiy, wiz, mx, my, mz, a) / torch.clamp(
        4.0 * torch.abs(rx * mx + ry * my + rz * mz), min=1e-20)
    g1w = _ggx_g1(wix, wiy, wiz, mx, my, mz, a)
    g1o = _ggx_g1(rx, ry, rz, mx, my, mz, a)
    wgt = torch.where(g1w > 0.0, g1w * g1o / torch.clamp(g1w, min=1e-20), 0.0)
    w = tuple(_fr_cond(cim, C[c], C[c + 3]) * wgt for c in range(3))
    pdf = torch.where((wiz > 0.0) & (rz > 0.0), pdf, 0.0)
    return (rx, ry, rz), w, pdf


def _sample_rough_dielectric(wi, u_lobe, u1, u2, a, eta_d):
    """RoughDielectric.sample: (local wo, weight, pdf, eta)."""
    wix, wiy, wiz = wi
    sgn_i = torch.where(wiz >= 0.0, 1.0, -1.0)
    mdx, mdy, mdz = _vndf_sample(wix * sgn_i, wiy * sgn_i, wiz * sgn_i,
                                 u1, u2, a)
    mox, moy, moz = mdx * sgn_i, mdy * sgn_i, mdz * sgn_i
    cim = wix * mox + wiy * moy + wiz * moz
    fD, cos_t, eta_it, eta_ti = _fr_diel(cim, eta_d)
    pick = u_lobe <= fD
    tfac = cim * eta_ti + cos_t
    wx = torch.where(pick, 2.0 * cim * mox - wix, mox * tfac - wix * eta_ti)
    wy = torch.where(pick, 2.0 * cim * moy - wiy, moy * tfac - wiy * eta_ti)
    wz = torch.where(pick, 2.0 * cim * moz - wiz, moz * tfac - wiz * eta_ti)
    g1i = _ggx_g1(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, mdx, mdy, mdz, a)
    sgn_o = torch.where(wz >= 0.0, 1.0, -1.0)
    g2 = g1i * _ggx_g1(wx * sgn_o, wy * sgn_o, wz * sgn_o, mdx, mdy, mdz, a)
    w = torch.where(g1i > 0.0, g2 / torch.clamp(g1i, min=1e-20), 0.0)
    w = torch.where(pick, w, w * (eta_ti * eta_ti))
    pdm = _vndf_pdf(wix * sgn_i, wiy * sgn_i, wiz * sgn_i, mdx, mdy, mdz, a)
    com = wx * mox + wy * moy + wz * moz
    jr = 1.0 / torch.clamp(4.0 * torch.abs(com), min=1e-20)
    den = cim + eta_it * com
    jt = torch.abs(com) * (eta_it * eta_it) / torch.clamp(den * den,
                                                          min=1e-20)
    pdf = pdm * torch.where(pick, fD * jr, (1.0 - fD) * jt)
    same = wz * wiz > 0.0
    valid = torch.where(pick, same, ~same & (cos_t != 0.0))
    return ((wx, wy, wz), w, torch.where(valid, pdf, 0.0),
            torch.where(pick, 1.0, eta_it))


def _barycentrics(row, ox, oy, oz, dx, dy, dz):
    """The hit's barycentrics (b0, u, v) on the winner's face, clipped
    (compute_si mirror)."""
    E1x, E1y, E1z, E2x, E2y, E2z = row[:, 3:9].unbind(-1)
    pvx, pvy, pvz = cross3(dx, dy, dz, E2x, E2y, E2z)
    det = E1x * pvx + E1y * pvy + E1z * pvz
    okd = torch.abs(det) > DET_EPS
    inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - row[:, 0], oy - row[:, 1], oz - row[:, 2]
    ub = torch.clamp((tvx * pvx + tvy * pvy + tvz * pvz) * inv, 0.0, 1.0)
    qvx, qvy, qvz = cross3(tvx, tvy, tvz, E1x, E1y, E1z)
    vb = torch.clamp((dx * qvx + dy * qvy + dz * qvz) * inv, 0.0, 1.0)
    return 1.0 - ub - vb, ub, vb


def _tex_eval(tex, off, W, H, nearest, wrap, u, v):
    """BitmapTexture.eval over the channel-planar arena ``tex``, one
    texture a lane (the TPU kernel's _tex_eval): (R, G, B) and the arena
    floats each lane reads (3 nearest, 12 bilinear)."""
    uu = torch.where(wrap > 0.5, u - torch.floor(u), torch.clamp(u, 0.0, 1.0))
    vv = torch.where(wrap > 0.5, v - torch.floor(v), torch.clamp(v, 0.0, 1.0))
    x = uu * W - 0.5
    y = (1.0 - vv) * H - 0.5
    Wi, Hi, offi = W.long(), H.long(), off.long()
    hw = Wi * Hi

    def clip(i, hi):
        return torch.minimum(torch.maximum(i, torch.zeros_like(i)), hi - 1)

    def fetch(idx):   # rows that are not textured index anywhere: clamp
        return tex[idx.clamp(0, tex.numel() - 1)]

    xn = clip(torch.round(x).long(), Wi)
    yn = clip(torch.round(y).long(), Hi)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = clip(x0.long(), Wi)
    x1i = clip(x0i + 1, Wi)
    y0i = clip(y0.long(), Hi)
    y1i = clip(y0i + 1, Hi)
    out = []
    for c in range(3):
        po = offi + c * hw
        near = fetch(po + yn * Wi + xn)
        b00 = fetch(po + y0i * Wi + x0i)
        b10 = fetch(po + y0i * Wi + x1i)
        b01 = fetch(po + y1i * Wi + x0i)
        b11 = fetch(po + y1i * Wi + x1i)
        bil = (b00 * (1 - fx) * (1 - fy) + b10 * fx * (1 - fy)
               + b01 * (1 - fx) * fy + b11 * fx * fy)
        out.append(torch.where(nearest > 0.5, near, bil))
    return out, torch.where(nearest > 0.5, 3, 12)


def _plastic_terms(C, R, cos_i):
    """The plastics' shared terms: (eta clamped above 1, F at wi, 1 /
    eta^2, each channel's reflectance over its internal-scattering
    denominator)."""
    eta_p = torch.clamp(C[0], min=1.0 + 1e-4)
    fdr, nl = C[1], C[2] > 0.5
    F_i = _fr_diel(cos_i, eta_p)[0]
    inv_eta2 = 1.0 / (eta_p * eta_p)
    base = tuple(r / torch.clamp(1.0 - torch.where(nl, r * fdr, fdr),
                                 min=1e-6) for r in R)
    return eta_p, F_i, inv_eta2, base


def _nee_plastic(cos_i, cos_o, C, R, ggx=None):
    """SmoothPlastic eval and pdf toward the light, whose local direction
    has the cosine ``cos_o``: ((f_r, f_g, f_b) x cos, pdf); RoughPlastic's
    with ``ggx`` = (local wi, local wo, alpha)."""
    eta_p, F_i, inv_eta2, base = _plastic_terms(C, R, cos_i)
    F_o = _fr_diel(cos_o, eta_p)[0]
    fac = (INV_PI * torch.clamp(cos_o, min=0.0) * (1.0 - F_i) * (1.0 - F_o)
           * inv_eta2)
    f = tuple(b * fac for b in base)
    cos_pdf = INV_PI * torch.clamp(cos_o, min=0.0)
    if ggx is None:
        return f, cos_pdf * (1.0 - F_i)
    (wix, wiy, wiz), (wox, woy, woz), a = ggx
    hx, hy, hz = wix + wox, wiy + woy, wiz + woz
    hn = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    hx, hy, hz = hx / hn, hy / hn, hz / hn
    F_m = _fr_diel(wix * hx + wiy * hy + wiz * hz, eta_p)[0]
    g2 = (_ggx_g1(wix, wiy, wiz, hx, hy, hz, a)
          * _ggx_g1(wox, woy, woz, hx, hy, hz, a))
    spec = F_m * _ggx_d(hx, hy, hz, a) * g2 / torch.clamp(4.0 * wiz,
                                                          min=1e-20)
    jac = 1.0 / torch.clamp(4.0 * torch.abs(wox * hx + woy * hy + woz * hz),
                            min=1e-20)
    pdf = (F_i * _vndf_pdf(wix, wiy, wiz, hx, hy, hz, a) * jac
           + (1.0 - F_i) * cos_pdf)
    return tuple(x + spec for x in f), pdf


def _sample_rough_plastic(wi, pick_spec, u1, u2, diffuse, a, C, R):
    """RoughPlastic.sample: the VNDF reflection on ``pick_spec`` lanes,
    else the cosine sample ``diffuse`` (local); (local wo, (w_r, w_g,
    w_b), pdf)."""
    wix, wiy, wiz = wi
    eta_p, F_i, inv_eta2, base = _plastic_terms(C, R, wiz)
    mx, my, mz = _vndf_sample(wix, wiy, wiz, u1, u2, a)
    cim = wix * mx + wiy * my + wiz * mz
    lx = torch.where(pick_spec, 2.0 * cim * mx - wix, diffuse[0])
    ly = torch.where(pick_spec, 2.0 * cim * my - wiy, diffuse[1])
    lz = torch.where(pick_spec, 2.0 * cim * mz - wiz, diffuse[2])
    hx, hy, hz = wix + lx, wiy + ly, wiz + lz
    hn = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    hx, hy, hz = hx / hn, hy / hn, hz / hn
    F_m = _fr_diel(wix * hx + wiy * hy + wiz * hz, eta_p)[0]
    g2 = (_ggx_g1(wix, wiy, wiz, hx, hy, hz, a)
          * _ggx_g1(lx, ly, lz, hx, hy, hz, a))
    spec = F_m * _ggx_d(hx, hy, hz, a) * g2 / torch.clamp(4.0 * wiz,
                                                          min=1e-20)
    F_o = _fr_diel(lz, eta_p)[0]
    fac = (INV_PI * torch.clamp(lz, min=0.0) * (1.0 - F_i) * (1.0 - F_o)
           * inv_eta2)
    jac = 1.0 / torch.clamp(4.0 * torch.abs(lx * hx + ly * hy + lz * hz),
                            min=1e-20)
    pdf = (F_i * _vndf_pdf(wix, wiy, wiz, hx, hy, hz, a) * jac
           + (1.0 - F_i) * INV_PI * torch.clamp(lz, min=0.0))
    ok = (wiz > 0.0) & (lz > 0.0) & (pdf > 1e-20)
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    w = tuple((b * fac + spec) * inv_pdf for b in base)
    return (lx, ly, lz), w, torch.where(ok, pdf, 0.0)


@dataclass
class EnvView:
    """The environment map's arena and meta as the plain versions read
    them: the texels (H, W, 4), the sampling distribution over the
    arena's CDFs, the meta as floats and the map's position among the
    emitters."""

    texels: torch.Tensor
    distr: Marginal2D
    meta: list
    pos: int

    @property
    def size(self):
        return int(self.meta[10]), int(self.meta[11])

    @property
    def search_floats(self) -> int:
        """Floats an NEE draw reads besides its texels: the steps of both
        binary searches (at most the bit length of each CDF's length),
        the row's and the column's lower CDF value, the row weight and
        two table cells."""
        w, h = self.size
        return h.bit_length() + w.bit_length() + 5


def env_view(env_data=None, env_meta=None, env_pos=-1) -> EnvView | None:
    """An ``EnvView`` of ``pack_env``'s arena and meta, None without."""
    if env_data is None:
        return None
    meta = [float(x) for x in env_meta.cpu()]
    w, h = int(meta[10]), int(meta[11])
    n_tex = ENV_TEXEL * h * w
    texels = env_data[:n_tex].view(h, w, ENV_TEXEL)
    row_cdf = env_data[n_tex:n_tex + h]
    row_w = env_data[n_tex + h:n_tex + 2 * h]
    cond = env_data[n_tex + 2 * h:].view(h, w)
    distr = Marginal2D(pdf_table=texels[..., 3], row_cdf=row_cdf,
                       cond_cdf=cond, row_weight=row_w,
                       total=env_meta[14].to(env_data.device))
    return EnvView(texels=texels, distr=distr, meta=meta, pos=int(env_pos))


def env_nee_sample(env: EnvView, seed, lane, depth: int):
    """The environment map's NEE candidate of each lane at ``depth``, as
    the kernels draw it: the port's counterpart of the JAX package's
    ``megapath._env_nee_table`` for one depth (rng -> Marginal2D.sample ->
    _uv_to_dir -> the spawn_ray_to renormalisation).  Returns (N, 8):
    direction (3), pdf x selection pmf, Le / pdf / selection pmf (3) and
    the shadow ray's maxt."""
    m = env.meta
    u2 = rng.sample_2d(seed, rng.as_u32(lane),
                       DIM_BOUNCE_BASE + depth * DIMS_PER_BOUNCE + SLOT_EM_POS)
    uv, pdf_uv = env.distr.sample(u2)
    d_env, st = uv_to_dir(uv)
    d = tf.apply_vector(torch.tensor(m[17:26], device=uv.device).view(3, 3),
                        d_env)
    pdf = safe_div(pdf_uv, UV_TO_SOLID_ANGLE * torch.clamp(st, min=1e-6))
    le = bilinear(env.texels[..., :3], uv) * m[9]
    w = torch.where((pdf > 0.0)[..., None],
                    le / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    delta = d * m[26]
    dx, dy, dz = delta.unbind(-1)
    dist = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-20))
    sel = m[15]
    inv_sel = 1.0 / max(sel, 1e-20)
    return torch.stack([dx / dist, dy / dist, dz / dist, pdf * sel,
                        *(w * inv_sel).unbind(-1), dist * (1.0 - 1e-3)], -1)


def _env_escape(env: EnvView, dx, dy, dz):
    """The TPU kernel's escape evaluation (:866-930): the environment's
    radiance along (dx, dy, dz) (bilinear, times the scale) and the NEE
    pdf of the direction, selection pmf included."""
    m = env.meta
    w, h = env.size
    exv = m[0] * dx + m[1] * dy + m[2] * dz
    eyv = m[3] * dx + m[4] * dy + m[5] * dz
    ezv = m[6] * dx + m[7] * dy + m[8] * dz
    ue = torch.atan2(exv.double(), -ezv.double()).float() * (0.5 / math.pi)
    ue = ue - torch.floor(ue)
    ve = torch.acos(torch.clamp(eyv, -1.0, 1.0).double()).float() \
        * (1.0 / math.pi)
    uv = torch.stack([ue, ve], -1)
    le = bilinear(env.texels[..., :3], uv) * m[9]
    ce = torch.clamp((ue * float(w)).long(), 0, w - 1)
    re = torch.clamp((ve * float(h)).long(), 0, h - 1)
    cell = env.texels[re, ce, 3]
    tot = m[14]
    pdf_uv = cell * float(w * h) / tot if abs(tot) > 1e-20 \
        else torch.zeros_like(cell)
    cos_t = torch.cos((math.pi * ve).double()).float()
    st_e = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    two_pi2 = 2.0 * float(np.float32(np.float32(math.pi) ** 2))
    pdf_env = pdf_uv / (two_pi2 * torch.clamp(st_e, min=1e-6)) * m[15]
    return le, pdf_env


def bounce_step(tris, closest, anyhit, light, n_lights, depth, max_depth,
                rr_depth, lane, seed, state, smooth, btypes=(0,), tex=None,
                counts=None, env: EnvView | None = None):
    """One bounce over all lanes: JAX ``_bounce_step`` for ``btypes`` (a
    set of ported codes; (0,) is the diffuse-only specialisation).

    ``closest(ox..dz, act) -> (t, face or -1)`` and
    ``anyhit(ox..dz, maxt, act) -> occluded`` are the hit queries (brute
    force or the BVH walk); ``state`` is the 16-tuple of
    ``initial_state``; ``tex`` the texture arena of a textured code;
    ``env`` the environment map (``env_view``).  Fields other than L and
    act are meaningful only for lanes still active afterwards.
    ``counts``, when a dict, gains ``tex_floats`` and ``env_floats``."""
    (ox, oy, oz, dx, dy, dz, Lr, Lg, Lb, Br, Bg, Bb, eta,
     prev_pdf, prev_delta, act) = state
    light = light[:max(n_lights, 1)]
    dbase = DIM_BOUNCE_BASE + depth * DIMS_PER_BOUNCE
    multi = tuple(btypes) != (BSDF_DIFFUSE,)
    # the two-sided wrapper is +16 on the nested code; the lobe flags
    # look at the nested codes
    inner = {b % TWO_SIDED for b in btypes}
    has_ts = any(b >= TWO_SIDED for b in btypes)
    has_tex = BSDF_TEX_DIFFUSE in inner
    has_cond = BSDF_CONDUCTOR in inner
    has_diel = BSDF_DIELECTRIC in inner
    has_rcond = BSDF_ROUGH_CONDUCTOR in inner
    has_rdiel = BSDF_ROUGH_DIELECTRIC in inner
    has_pl = BSDF_PLASTIC in inner
    has_rpl = BSDF_ROUGH_PLASTIC in inner

    t, bj = closest(ox, oy, oz, dx, dy, dz, act)
    # the winner's attributes; a miss reads zeros
    row = torch.where((bj >= 0)[:, None], tris[bj.clamp(min=0)], 0.0)
    (E1x, E1y, E1z, E2x, E2y, E2z) = row[:, 3:9].unbind(-1)
    Rr, Rg, Rb = row[:, 9:12].unbind(-1)
    IsL, PdfA = row[:, 15], row[:, 16]
    btype = row[:, 17]
    ngx, ngy, ngz = _normalize3(*cross3(E1x, E1y, E1z, E2x, E2y, E2z))
    if smooth or has_tex:
        b0, ub, vb = _barycentrics(row, ox, oy, oz, dx, dy, dz)
    if has_tex:
        # a textured face's reflectance from the arena at its uv; codes 5
        # and 21 then go on as the constant diffuse (0 and 16)
        uvx = row[:, 24] * b0 + row[:, 26] * ub + row[:, 28] * vb
        uvy = row[:, 25] * b0 + row[:, 27] * ub + row[:, 29] * vb
        is_texd = (((btype >= 4.5) & (btype < 5.5))
                   | ((btype >= 20.5) & (btype < 21.5)))
        (tr, tg, tb), n_floats = _tex_eval(tex, *row[:, 18:23].unbind(-1),
                                           uvx, uvy)
        Rr = torch.where(is_texd, tr, Rr)
        Rg = torch.where(is_texd, tg, Rg)
        Rb = torch.where(is_texd, tb, Rb)
        btype = torch.where(is_texd, torch.where(btype >= 15.5, 16.0, 0.0),
                            btype)
        if counts is not None:
            counts["tex_floats"] = counts.get("tex_floats", 0) + int(
                n_floats[is_texd & act & torch.isfinite(t)].sum())
    if smooth:
        # the interpolated shading normal; flat faces store ng at all 3
        # slots
        nsx = row[:, 30] * b0 + row[:, 33] * ub + row[:, 36] * vb
        nsy = row[:, 31] * b0 + row[:, 34] * ub + row[:, 37] * vb
        nsz = row[:, 32] * b0 + row[:, 35] * ub + row[:, 38] * vb
        n2 = nsx * nsx + nsy * nsy + nsz * nsz
        rinv = torch.where(n2 > 1e-20,
                           1.0 / torch.sqrt(torch.clamp(n2, min=1e-20)), 0.0)
        shx, shy, shz = nsx * rinv, nsy * rinv, nsz * rinv
    else:
        shx, shy, shz = ngx, ngy, ngz
    valid = torch.isfinite(t) & act
    if env is not None:
        # escaped rays collect the environment, with MIS (path.py:85-92)
        escaped = act & ~valid
        le_env, pdf_env = _env_escape(env, dx, dy, dz)
        m_esc = torch.where(prev_delta, 1.0, _mis(prev_pdf, pdf_env))
        Lr = Lr + Br * torch.where(escaped, le_env[:, 0] * m_esc, 0.0)
        Lg = Lg + Bg * torch.where(escaped, le_env[:, 1] * m_esc, 0.0)
        Lb = Lb + Bb * torch.where(escaped, le_env[:, 2] * m_esc, 0.0)
        if counts is not None:
            counts["env_floats"] = counts.get("env_floats", 0) + int(
                escaped.sum()) * (4 * ENV_TEXEL + 1)

    no = torch.zeros_like(act)
    if has_ts:
        ts_flag = btype >= 15.5
        btype = btype - torch.where(ts_flag, 16.0, 0.0)
    if multi:
        C = row[:, 18:24].unbind(-1)
        is_diff = btype < 0.5
        is_cond = (btype >= 0.5) & (btype < 1.5)
        is_diel = (btype >= 1.5) & (btype < 2.5)
        is_rcond = (btype >= 2.5) & (btype < 3.5)
        is_rdiel = (btype >= 3.5) & (btype < 4.5)
        is_pl = (btype >= 5.5) & (btype < 6.5)
        is_rpl = btype >= 6.5
    else:
        is_diff = torch.ones_like(act)
        is_cond = is_diel = is_rcond = is_rdiel = is_pl = is_rpl = no

    lc = light[0]
    Er, Eg, Eb = IsL * lc[14], IsL * lc[15], IsL * lc[16]
    px = ox + dx * t
    py = oy + dy * t
    pz = oz + dz * t
    # diffuse, conductors and plastics are one-sided (front iff -d.n >
    # 0); dielectrics two-sided
    cos_wi = -(dx * shx + dy * shy + dz * shz)
    cos_wi_sgn = cos_wi    # signed: the mirror direction's
    cos_geo = -(dx * ngx + dy * ngy + dz * ngz)
    if has_ts:
        # twosided.cpp: a back hit evaluates the nested BSDF in the frame
        # flipped about the surface (wi.z and the sampled wo.z flip)
        flip = ts_flag & (cos_wi < 0.0)
        cos_wi = torch.where(flip, -cos_wi, cos_wi)
    else:
        flip = no
    front = cos_wi > 0.0

    # ---- MIS'd radiance of directly hit emitters (path.py:82) ----
    dist2 = t * t
    pdf_hit = torch.where(cos_geo > 1e-6,
                          PdfA * dist2 / torch.clamp(cos_geo, min=1e-6), 0.0)
    if env is not None:
        pdf_hit = pdf_hit * env.meta[16]   # the area light's selection pmf
    m_h = torch.where(prev_delta, 1.0, _mis(prev_pdf, pdf_hit))
    wgt = torch.where(valid & front & (IsL > 0.5), m_h, 0.0)
    Lr = Lr + Br * Er * wgt
    Lg = Lg + Bg * Eg * wgt
    Lb = Lb + Bb * Eb * wgt

    act_next = valid & (front | is_diel | is_rdiel)
    if depth + 1 >= max_depth:
        act_next = torch.zeros_like(act_next)

    # spawn-ray offset scale (records.py spawn_ray)
    off = RAY_EPS * torch.clamp(torch.maximum(
        torch.abs(px), torch.maximum(torch.abs(py), torch.abs(pz))), min=1.0)
    s, tt = coordinate_system(torch.stack([shx, shy, shz], dim=-1))
    sx, sy, sz = s.unbind(-1)
    tx, ty, tz = tt.unbind(-1)
    if has_rcond or has_rdiel or has_rpl:
        # local wi of the GGX lobes; alpha rides column 16
        wi = (-(dx * sx + dy * sy + dz * sz), -(dx * tx + dy * ty + dz * tz),
              cos_wi)
        alpha = torch.clamp(PdfA, min=1e-4)

    # ---- NEE toward the area light or the environment (path.py:92-105) ----
    u_sel = rng.sample_1d(seed, lane, dbase + SLOT_EM_SELECT)
    ue = rng.sample_2d(seed, lane, dbase + SLOT_EM_POS)
    u_face = u_sel
    if env is not None:
        # the uniform pick of one of the (one or two) emitters, reusing
        # u_sel for the light's face (sample_reuse_pmf; :1014-1030)
        if n_lights > 0:
            second = u_sel > 0.5
            pick_env = second if env.pos == 1 else ~second
            lo_sel = torch.where(second, 0.5, 0.0)
            u_face = torch.clamp((u_sel - lo_sel) / 0.5, 0.0, 1.0 - 2.0 ** -24)
        else:
            pick_env = torch.ones_like(act)
            u_face = torch.clamp(u_sel, 0.0, 1.0 - 2.0 ** -24)
    idx = torch.zeros_like(u_sel)
    for j in range(n_lights):
        idx = idx + (light[j, 12] < u_face).to(torch.float32)
    # the selected light row; a u past the last cdf entry selects none
    idx = idx.to(torch.int64)
    sel = torch.where((idx < n_lights)[:, None],
                      light[idx.clamp(max=light.shape[0] - 1)], 0.0)
    (lp0x, lp0y, lp0z, le1x, le1y, le1z, le2x, le2y, le2z,
     lnx, lny, lnz) = sel[:, :12].unbind(-1)
    lpdfA = sel[:, 13]
    Ler, Leg, Leb = sel[:, 14:17].unbind(-1)
    b0, b1 = warp.square_to_uniform_triangle(ue).unbind(-1)
    lpx = lp0x + le1x * b0 + le2x * b1
    lpy = lp0y + le1y * b0 + le2y * b1
    lpz = lp0z + le1z * b0 + le2z * b1
    sdx = lpx - px
    sdy = lpy - py
    sdz = lpz - pz
    sdist2 = torch.clamp(sdx * sdx + sdy * sdy + sdz * sdz, min=1e-12)
    sdist = torch.sqrt(sdist2)
    sdx, sdy, sdz = sdx / sdist, sdy / sdist, sdz / sdist
    cos_l = -(sdx * lnx + sdy * lny + sdz * lnz)
    pdf_nee = torch.where(cos_l > 1e-6,
                          lpdfA * sdist2 / torch.clamp(cos_l, min=1e-6), 0.0)
    maxt_s = sdist * (1.0 - 1e-3)
    if env is None:
        pdf_eff = pdf_nee
        inv_pa = 1.0 / torch.clamp(pdf_nee, min=1e-20)
        Wr_nee, Wg_nee, Wb_nee = Ler * inv_pa, Leg * inv_pa, Leb * inv_pa
    else:
        # the envmap's candidate where it was picked (:1064-1075)
        cand = env_nee_sample(env, seed, lane, depth).unbind(-1)
        sdx = torch.where(pick_env, cand[0], sdx)
        sdy = torch.where(pick_env, cand[1], sdy)
        sdz = torch.where(pick_env, cand[2], sdz)
        maxt_s = torch.where(pick_env, cand[7], maxt_s)
        sel_area = env.meta[16]
        pdf_eff = torch.where(pick_env, cand[3], pdf_nee * sel_area)
        inv_pa = 1.0 / (torch.clamp(pdf_nee, min=1e-20) * sel_area)
        Wr_nee = torch.where(pick_env, cand[4], Ler * inv_pa)
        Wg_nee = torch.where(pick_env, cand[5], Leg * inv_pa)
        Wb_nee = torch.where(pick_env, cand[6], Leb * inv_pa)
        if counts is not None:
            counts["env_floats"] = counts.get("env_floats", 0) + int(
                (pick_env & act_next).sum()) * (4 * ENV_TEXEL
                                                + env.search_floats)
    cos_s = sdx * shx + sdy * shy + sdz * shz
    if has_ts:
        cos_s = torch.where(flip, -cos_s, cos_s)   # the flipped frame's wo.z
    # each lobe's f x cos and pdf toward the light; the delta lobes
    # evaluate to 0 and trace no shadow ray
    f_pdf = INV_PI * torch.clamp(cos_s, min=0.0)
    fr_nee = Rr * (INV_PI * cos_s)
    fg_nee = Rg * (INV_PI * cos_s)
    fb_nee = Rb * (INV_PI * cos_s)
    nee_lobe = is_diff | is_rcond | is_pl | is_rpl
    ok_nee = act_next & (pdf_eff > 0.0) & (
        (nee_lobe & front & (cos_s > 0.0)) | is_rdiel)
    if has_rcond or has_rdiel or has_rpl:
        wo = (sdx * sx + sdy * sy + sdz * sz, sdx * tx + sdy * ty + sdz * tz,
              cos_s)

    def take(mask, f, pdf):
        nonlocal fr_nee, fg_nee, fb_nee, f_pdf
        fr_nee = torch.where(mask, f[0], fr_nee)
        fg_nee = torch.where(mask, f[1], fg_nee)
        fb_nee = torch.where(mask, f[2], fb_nee)
        f_pdf = torch.where(mask, pdf, f_pdf)

    if has_rcond:
        take(is_rcond, *_nee_rough_conductor(wi, wo, alpha, C))
    if has_rdiel:
        val_d, pdf_d = _nee_rough_dielectric(wi, wo, alpha,
                                             torch.clamp(C[0], min=1e-3))
        take(is_rdiel, (val_d,) * 3, pdf_d)
        ok_nee = ok_nee & (~is_rdiel | (val_d > 0.0))
    if has_pl:
        take(is_pl, *_nee_plastic(cos_wi, cos_s, C, (Rr, Rg, Rb)))
    if has_rpl:
        take(is_rpl, *_nee_plastic(cos_wi, cos_s, C, (Rr, Rg, Rb),
                                   (wi, wo, alpha)))
    # the shadow ray leaves on the side of the GEOMETRIC normal
    sgn_s = torch.where(sdx * ngx + sdy * ngy + sdz * ngz >= 0.0, 1.0, -1.0)
    occ = anyhit(px + sgn_s * off * ngx, py + sgn_s * off * ngy,
                 pz + sgn_s * off * ngz, sdx, sdy, sdz, maxt_s, ok_nee)
    ok_nee = ok_nee & ~occ
    wnee = torch.where(ok_nee, _mis(pdf_eff, f_pdf), 0.0)
    # f and W carry inf/NaN on miss lanes (t = inf): the where wraps the
    # whole product, not just the weight
    Lr = Lr + Br * torch.where(ok_nee, fr_nee * wnee * Wr_nee, 0.0)
    Lg = Lg + Bg * torch.where(ok_nee, fg_nee * wnee * Wg_nee, 0.0)
    Lb = Lb + Bb * torch.where(ok_nee, fb_nee * wnee * Wb_nee, 0.0)

    # ---- BSDF sampling ----
    ub = rng.sample_2d(seed, lane, dbase + SLOT_BSDF_DIR)
    # diffuse: cosine hemisphere (SmoothDiffuse.sample); a two-sided back
    # hit scatters into the flipped hemisphere
    dxl, dyl, dzl = warp.square_to_cosine_hemisphere(ub).unbind(-1)
    dzl_w = torch.where(flip, -dzl, dzl) if has_ts else dzl
    ndx = sx * dxl + tx * dyl + shx * dzl_w
    ndy = sy * dxl + ty * dyl + shy * dzl_w
    ndz = sz * dxl + tz * dyl + shz * dzl_w
    pdf_diff = INV_PI * dzl
    pdf_fwd = pdf_diff
    wR, wG, wB = Rr, Rg, Rb
    eta_mult = torch.ones_like(eta)
    pick_sp = no
    if multi:
        u_lobe = rng.sample_1d(seed, lane, dbase + SLOT_BSDF_LOBE)

        def pick(mask, local, w, pdf, flip_z=True):
            """Take the lobe's world direction, weight and pdf on ``mask``
            lanes (``local`` is a local-frame direction, its z flipped
            back on a two-sided back hit)."""
            nonlocal ndx, ndy, ndz, wR, wG, wB, pdf_fwd
            lx, ly, lz = local
            if has_ts and flip_z:
                lz = torch.where(flip, -lz, lz)
            ndx = torch.where(mask, sx * lx + tx * ly + shx * lz, ndx)
            ndy = torch.where(mask, sy * lx + ty * ly + shy * lz, ndy)
            ndz = torch.where(mask, sz * lx + tz * ly + shz * lz, ndz)
            wR = torch.where(mask, w[0], wR)
            wG = torch.where(mask, w[1], wG)
            wB = torch.where(mask, w[2], wB)
            pdf_fwd = torch.where(mask, pdf, pdf_fwd)

        # the mirror direction, world form (conductor, dielectric and
        # plastic reflection); the signed cosine makes it the two-sided
        # back face's mirror too
        rx = dx + 2.0 * cos_wi_sgn * shx
        ry = dy + 2.0 * cos_wi_sgn * shy
        rz = dz + 2.0 * cos_wi_sgn * shz
        if has_cond:
            Fc = tuple(_fr_cond(cos_wi, C[c], C[c + 3]) for c in range(3))
            ndx = torch.where(is_cond, rx, ndx)
            ndy = torch.where(is_cond, ry, ndy)
            ndz = torch.where(is_cond, rz, ndz)
            wR = torch.where(is_cond, Fc[0], wR)
            wG = torch.where(is_cond, Fc[1], wG)
            wB = torch.where(is_cond, Fc[2], wB)
            pdf_fwd = torch.where(is_cond, 1.0, pdf_fwd)
        if has_diel:
            Fd, cos_t, eta_it, eta_ti = _fr_diel(
                cos_wi, torch.clamp(C[0], min=1e-3))
            # the refracted direction, world form (fresnel.py refract)
            tfac = eta_ti * cos_wi + cos_t
            pick_r = u_lobe <= Fd
            ndx = torch.where(is_diel, torch.where(pick_r, rx,
                                                   eta_ti * dx + tfac * shx),
                              ndx)
            ndy = torch.where(is_diel, torch.where(pick_r, ry,
                                                   eta_ti * dy + tfac * shy),
                              ndy)
            ndz = torch.where(is_diel, torch.where(pick_r, rz,
                                                   eta_ti * dz + tfac * shz),
                              ndz)
            w_diel = torch.where(pick_r, 1.0, eta_ti * eta_ti)
            wR = torch.where(is_diel, w_diel, wR)
            wG = torch.where(is_diel, w_diel, wG)
            wB = torch.where(is_diel, w_diel, wB)
            pdf_fwd = torch.where(is_diel, torch.where(pick_r, Fd, 1.0 - Fd),
                                  pdf_fwd)
            eta_mult = torch.where(is_diel & ~pick_r, eta_it, eta_mult)
        if has_rcond:
            pick(is_rcond, *_sample_rough_conductor(wi, ub[:, 0], ub[:, 1],
                                                    alpha, C))
        if has_rdiel:
            local, w_rd, pdf_rd, eta_rd = _sample_rough_dielectric(
                wi, u_lobe, ub[:, 0], ub[:, 1], alpha,
                torch.clamp(C[0], min=1e-3))
            pick(is_rdiel, local, (w_rd,) * 3, pdf_rd, flip_z=False)
            eta_mult = torch.where(is_rdiel, eta_rd, eta_mult)
        if has_pl or has_rpl:
            # plastic.cpp / roughplastic.cpp: the coat's reflection with the
            # Fresnel reflectance's probability, else the diffuse base
            eta_p, F_is, inv_eta2, base = _plastic_terms(C, (Rr, Rg, Rb),
                                                         cos_wi)
            pick_sp = (is_pl | is_rpl) & (u_lobe < F_is)
        if has_pl:
            # the smooth coat's mirror, or the cosine-sampled base
            wdf = inv_eta2 * (1.0 - _fr_diel(dzl, eta_p)[0])
            on = is_pl & pick_sp
            ndx = torch.where(on, rx, ndx)
            ndy = torch.where(on, ry, ndy)
            ndz = torch.where(on, rz, ndz)
            w_pl = [torch.where(pick_sp, 1.0, bc * wdf) for bc in base]
            wR = torch.where(is_pl, w_pl[0], wR)
            wG = torch.where(is_pl, w_pl[1], wG)
            wB = torch.where(is_pl, w_pl[2], wB)
            pdf_fwd = torch.where(is_pl, torch.where(
                pick_sp, F_is, pdf_diff * (1.0 - F_is)), pdf_fwd)
        if has_rpl:
            pick(is_rpl, *_sample_rough_plastic(
                wi, pick_sp, ub[:, 0], ub[:, 1], (dxl, dyl, dzl), alpha, C,
                (Rr, Rg, Rb)))
    Br = torch.where(act_next, Br * wR, Br)
    Bg = torch.where(act_next, Bg * wG, Bg)
    Bb = torch.where(act_next, Bb * wB, Bb)
    if multi:
        eta = torch.where(act_next, eta * eta_mult, eta)
    bmax = torch.maximum(Br, torch.maximum(Bg, Bb))
    act_next = act_next & (pdf_fwd > 0.0) & (bmax > 0.0)
    sgn_b = torch.where(ndx * ngx + ndy * ngy + ndz * ngz >= 0.0, 1.0, -1.0)
    ox = px + sgn_b * off * ngx
    oy = py + sgn_b * off * ngy
    oz = pz + sgn_b * off * ngz
    prev_pdf = torch.where(act_next, pdf_fwd, prev_pdf)
    # the Dirac lobes: smooth conductor and dielectric, and the smooth
    # plastic's coat when its reflection was picked
    prev_delta = torch.where(act_next, is_cond | is_diel | (is_pl & pick_sp),
                             prev_delta)

    # ---- russian roulette (path.py:117-128; eta^2 factor) ----
    if depth + 1 >= rr_depth:
        rr_p = torch.clamp(bmax * eta * eta, max=0.95)
        u_rr = rng.sample_1d(seed, lane, dbase + SLOT_RR)
        survive = u_rr < rr_p
        inv_p = 1.0 / torch.clamp(rr_p, min=1e-8)
        Br = torch.where(act_next, Br * inv_p, Br)
        Bg = torch.where(act_next, Bg * inv_p, Bg)
        Bb = torch.where(act_next, Bb * inv_p, Bb)
        act_next = act_next & survive
    return (ox, oy, oz, ndx, ndy, ndz, Lr, Lg, Lb, Br, Bg, Bb, eta,
            prev_pdf, prev_delta, act_next)
