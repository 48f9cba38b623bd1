"""Path-tracing megakernel: the whole bounce loop in one launch
(mitsuba_tpu/ops/pallas/megakernel.py, ``megakernel_trace``).

Each lane walks up to ``max_depth`` bounces: closest hit over every
face, emitter-hit MIS, area-light NEE with a shadow ray, cosine BSDF
sampling and russian roulette.  Sampling replays the JAX package's
stream exactly: the same PCG3D (seed, lane, dim) hash, the same
dimension layout, warps, frame construction and MIS/RR arithmetic, so
per-lane radiance agrees with the JAX kernel to float rounding.

Three pieces live here:

- ``pack_scene``: the 39-column triangle table and 17-column light table
  of the JAX package, column for column;
- ``megakernel_trace``: the wrapper.  On a CUDA tensor it launches the
  hand-written kernel in ``csrc/megakernel.cu`` (built with nvcc at
  first use) or raises; on a CPU tensor it runs the plain version.  The
  kernel's threads are persistent and regenerate paths: a thread whose
  path ends takes the next unstarted lane from a counter that the
  wrapper allocates; ``launch_config`` reports the grid;
- ``megakernel_trace_plain``: the plain PyTorch version, a transcription
  of the JAX ``_trace_loop``/``_bounce_step`` for this slice's
  specialisation onto (N,) tensors in the same order of operations.

The ported specialisation is ``btypes == (0,)`` (constant diffuse), flat
or smooth shading normals, no texture and no envmap; the wrapper raises
``ValueError`` for the others.  ``bounce_step`` is one bounce of the
plain version with the hit queries passed in, so the BVH kernels'
plain versions (ops/megakernel_bvh.py) run the same body.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng, warp
from ..core.math import RAY_EPS, coordinate_system, cross
from ..models.bsdfs import SmoothDiffuse
from ..models.emitters import AreaEmitter
from ..models.samplers import IndependentSampler
from ..models.textures import ConstantTexture
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
SLOT_BSDF_DIR = 3
SLOT_RR = 4

# triangle table columns:
#   0:3 p0, 3:6 e1, 6:9 e2, 9:12 reflectance, 12:15 emission,
#   15 is_light, 16 pdf_area, 17 bsdf_type, 18:24 type params,
#   24:30 uv0 uv1 uv2, 30:39 n0 n1 n2
TRI_COLS = 39
# light table columns: 0:3 p0, 3:6 e1, 6:9 e2, 9:12 n, 12 cdf,
#   13 pdf_area, 14:17 Le
LIGHT_COLS = 17


# ------------------------------------------------------------ scene packing

def plugin_subset_ok(scene) -> bool:
    """True iff the scene's plugins are inside the ported kernels'
    subset: constant diffuse BSDFs, exactly one constant-radiance area
    light of at most MAX_LIGHT_FACES faces, the independent sampler.
    Flat and smooth shading normals are both ported."""
    if len(scene.emitters) != 1:
        return False
    e, s = scene.emitters[0], scene.emitter_shape[0]
    if not (isinstance(e, AreaEmitter) and isinstance(e.radiance, ConstantTexture)
            and float(e.sampling_weight) == 1.0 and s >= 0):
        return False
    if int(scene.meshes[s].faces.shape[0]) > MAX_LIGHT_FACES:
        return False
    if not isinstance(scene.sensor.sampler, IndependentSampler):
        return False
    return all(isinstance(b, SmoothDiffuse)
               and isinstance(b.reflectance, ConstantTexture)
               for b in scene.bsdfs)


def megakernel_applicable(scene) -> bool:
    """True iff the brute kernel takes the scene: the plugin subset and
    at most MAX_FACES faces in all."""
    return plugin_subset_ok(scene) and \
        sum(int(m.faces.shape[0]) for m in scene.meshes) <= MAX_FACES


def pack_scene(scene):
    """Packed kernel tables (megakernel.py:291 of the JAX package).

    Returns (tris (F, TRI_COLS), light (max(L, 1), LIGHT_COLS), F, L).
    The NEE pdf of a light face is uniform 1/total_light_area in area
    measure.  Unlike the TPU tables, neither is padded to a tile.
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

    # per-BSDF rows [refl(3) | type(1) | params(6) | alpha(1)]; the
    # ported subset is constant diffuse: type 0, no params
    bsdf_tab = torch.stack([
        torch.cat([b.reflectance.value.to(torch.float32).reshape(3),
                   torch.zeros(8, device=dev)])
        for b in scene.bsdfs])
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
    return tris, light.contiguous(), F, L


# --------------------------------------------------------------- the wrapper

def megakernel_trace(tris, light, lane, o, d, active, seed,
                     max_depth: int, rr_depth: int, n_faces: int,
                     n_lights: int, btypes: tuple = (0,), tex=None,
                     env_meta=None, env_nee=None, env_pos: int = -1,
                     smooth: bool = False):
    """Per-lane path radiance L (N, 3) for rays (o, d) (N, 3).

    ``tris``/``light`` come from ``pack_scene``; ``lane`` is the int32
    RNG lane id, ``active`` a bool mask, ``seed`` the render seed;
    ``smooth`` interpolates the shading normal (columns 30:39).  On a
    CUDA tensor this launches the kernel (and counts the launch in
    ``megakernel_trace.launches``) or raises; on a CPU tensor it runs
    ``megakernel_trace_plain``.  Only the constant-diffuse, untextured,
    envmap-free specialisation is ported.
    """
    check_variant(btypes, tex, env_meta, env_nee, env_pos)
    if not 0 <= n_faces <= MAX_FACES or not 0 <= n_lights <= MAX_LIGHT_FACES:
        raise ValueError(f"{n_faces} faces / {n_lights} light faces exceed "
                         f"the kernel's {MAX_FACES} / {MAX_LIGHT_FACES}")
    if o.device.type == "cpu":
        return megakernel_trace_plain(tris, light, lane, o, d, active, seed,
                                      max_depth, rr_depth, n_faces, n_lights,
                                      smooth)
    return _trace_cuda(tris, light, lane, o, d, active, seed,
                       max_depth, rr_depth, n_faces, n_lights, smooth)


megakernel_trace.launches = 0


def check_variant(btypes, tex=None, env_meta=None, env_nee=None, env_pos=-1):
    """Raise ValueError for a kernel variant that is not ported."""
    if tuple(btypes) != (0,):
        raise ValueError(f"BSDF types {tuple(btypes)} are not ported; "
                         "only constant diffuse (0,) is")
    if tex is not None or env_meta is not None or env_nee is not None \
            or env_pos >= 0:
        raise ValueError("textures and envmaps are not ported to the "
                         "megakernels yet")


def check_tensor(name, x, dtype, shape, device):
    if x.dtype != dtype or x.device != device or not x.is_contiguous() \
            or x.dim() != len(shape) \
            or any(s is not None and s != xs for s, xs in zip(shape, x.shape)):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _library():
    lib = _build.load("megakernel")
    if lib.megakernel_trace.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.megakernel_trace.argtypes = [p, i, p, i, p, p, p, p,
                                         ctypes.c_uint32, i, i, i, i, p, p, p]
        lib.megakernel_trace.restype = i
        lib.megakernel_trace_config.argtypes = [i, i, i, p]
        lib.megakernel_trace_config.restype = i
    return lib


def launch_config(n_faces: int, n_lights: int, n: int) -> dict:
    """The persistent grid of a launch over ``n`` lanes on the current
    CUDA device: blocks, resident blocks per SM (the occupancy
    calculator's), threads a block, SMs."""
    cfg = (ctypes.c_int * 4)()
    rc = _library().megakernel_trace_config(n_faces, n_lights, n, cfg)
    if rc != 0:
        raise RuntimeError(f"megakernel_trace_config: CUDA error {rc}")
    return {"blocks": cfg[0], "resident_per_sm": cfg[1], "threads": cfg[2],
            "sms": cfg[3]}


def _trace_cuda(tris, light, lane, o, d, active, seed, max_depth, rr_depth,
                n_faces, n_lights, smooth):
    dev = o.device
    n = int(o.shape[0])
    check_tensor("tris", tris, torch.float32, (None, TRI_COLS), dev)
    check_tensor("light", light, torch.float32, (None, LIGHT_COLS), dev)
    check_tensor("lane", lane, torch.int32, (n,), dev)
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    if tris.shape[0] < n_faces or light.shape[0] < n_lights:
        raise ValueError("tables are shorter than n_faces / n_lights")
    fn = _library().megakernel_trace
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    next_slot = torch.zeros(1, dtype=torch.int32, device=dev)  # the schedule
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(tris.data_ptr(), n_faces, light.data_ptr(), n_lights,
                lane.data_ptr(), o.data_ptr(), d.data_ptr(), active.data_ptr(),
                int(seed) & rng.MASK32, max_depth, rr_depth, int(smooth), n,
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
                           counts: dict | None = None):
    """Plain PyTorch version of the kernel, on any device.

    When ``counts`` is a dict it receives the work the kernel does on
    these inputs: ``closest_tests`` (ray-triangle tests of the closest-hit
    sweeps, every face for each lane still active at a bounce) and
    ``shadow_tests`` (tests of the shadow rays, which stop at their first
    occluder).
    """
    if counts is not None:
        counts.setdefault("closest_tests", 0)
        counts.setdefault("shadow_tests", 0)
    closest, anyhit = _brute_queries(tris[:n_faces].tolist(), counts)
    state = initial_state(o, d, active)
    for depth in range(max_depth):
        state = bounce_step(tris, closest, anyhit, light, n_lights, depth,
                            max_depth, rr_depth, rng.as_u32(lane), seed,
                            state, smooth)
    return torch.stack(state[6:9], dim=-1)


def bounce_step(tris, closest, anyhit, light, n_lights, depth, max_depth,
                rr_depth, lane, seed, state, smooth):
    """One bounce over all lanes: JAX ``_bounce_step`` with btypes == (0,).

    ``closest(ox..dz, act) -> (t, face or -1)`` and
    ``anyhit(ox..dz, maxt, act) -> occluded`` are the hit queries (brute
    force or the BVH walk); ``state`` is the 16-tuple of
    ``initial_state``.  Fields other than L and act are meaningful only
    for lanes still active afterwards."""
    (ox, oy, oz, dx, dy, dz, Lr, Lg, Lb, Br, Bg, Bb, eta,
     prev_pdf, prev_delta, act) = state
    light = light[:max(n_lights, 1)]
    dbase = DIM_BOUNCE_BASE + depth * DIMS_PER_BOUNCE

    t, bj = closest(ox, oy, oz, dx, dy, dz, act)
    # the winner's attributes; a miss reads zeros
    row = torch.where((bj >= 0)[:, None], tris[bj.clamp(min=0)], 0.0)
    (E1x, E1y, E1z, E2x, E2y, E2z) = row[:, 3:9].unbind(-1)
    Rr, Rg, Rb = row[:, 9:12].unbind(-1)
    IsL, PdfA = row[:, 15], row[:, 16]
    ngx, ngy, ngz = _normalize3(*cross3(E1x, E1y, E1z, E2x, E2y, E2z))
    if smooth:
        # the winner's barycentrics, clipped (compute_si mirror), and the
        # interpolated shading normal; flat faces store ng at all 3 slots
        pvx, pvy, pvz = cross3(dx, dy, dz, E2x, E2y, E2z)
        det = E1x * pvx + E1y * pvy + E1z * pvz
        okd = torch.abs(det) > DET_EPS
        inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - row[:, 0], oy - row[:, 1], oz - row[:, 2]
        ub = torch.clamp((tvx * pvx + tvy * pvy + tvz * pvz) * inv, 0.0, 1.0)
        qvx, qvy, qvz = cross3(tvx, tvy, tvz, E1x, E1y, E1z)
        vb = torch.clamp((dx * qvx + dy * qvy + dz * qvz) * inv, 0.0, 1.0)
        b0 = 1.0 - ub - vb
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

    lc = light[0]
    Er, Eg, Eb = IsL * lc[14], IsL * lc[15], IsL * lc[16]
    px = ox + dx * t
    py = oy + dy * t
    pz = oz + dz * t
    cos_wi = -(dx * shx + dy * shy + dz * shz)
    cos_geo = -(dx * ngx + dy * ngy + dz * ngz)
    front = cos_wi > 0.0

    # ---- MIS'd radiance of directly hit emitters (path.py:82) ----
    dist2 = t * t
    pdf_hit = torch.where(cos_geo > 1e-6,
                          PdfA * dist2 / torch.clamp(cos_geo, min=1e-6), 0.0)
    m_h = torch.where(prev_delta, 1.0, _mis(prev_pdf, pdf_hit))
    wgt = torch.where(valid & front & (IsL > 0.5), m_h, 0.0)
    Lr = Lr + Br * Er * wgt
    Lg = Lg + Bg * Eg * wgt
    Lb = Lb + Bb * Eb * wgt

    act_next = valid & front
    if depth + 1 >= max_depth:
        act_next = torch.zeros_like(act_next)

    # spawn-ray offset scale (records.py spawn_ray)
    off = RAY_EPS * torch.clamp(torch.maximum(
        torch.abs(px), torch.maximum(torch.abs(py), torch.abs(pz))), min=1.0)
    s, tt = coordinate_system(torch.stack([shx, shy, shz], dim=-1))
    sx, sy, sz = s.unbind(-1)
    tx, ty, tz = tt.unbind(-1)

    # ---- NEE toward the area light (path.py:92-105) ----
    u_sel = rng.sample_1d(seed, lane, dbase + SLOT_EM_SELECT)
    ue = rng.sample_2d(seed, lane, dbase + SLOT_EM_POS)
    idx = torch.zeros_like(u_sel)
    for j in range(n_lights):
        idx = idx + (light[j, 12] < u_sel).to(torch.float32)
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
    inv_pa = 1.0 / torch.clamp(pdf_nee, min=1e-20)
    Wr_nee, Wg_nee, Wb_nee = Ler * inv_pa, Leg * inv_pa, Leb * inv_pa
    cos_s = sdx * shx + sdy * shy + sdz * shz
    ok_nee = act_next & (pdf_nee > 0.0) & (cos_s > 0.0)
    # the shadow ray leaves on the side of the GEOMETRIC normal
    sgn_s = torch.where(sdx * ngx + sdy * ngy + sdz * ngz >= 0.0, 1.0, -1.0)
    occ = anyhit(px + sgn_s * off * ngx, py + sgn_s * off * ngy,
                 pz + sgn_s * off * ngz, sdx, sdy, sdz, maxt_s, ok_nee)
    ok_nee = ok_nee & ~occ
    f_pdf = INV_PI * torch.clamp(cos_s, min=0.0)
    fr_nee = Rr * (INV_PI * cos_s)
    fg_nee = Rg * (INV_PI * cos_s)
    fb_nee = Rb * (INV_PI * cos_s)
    wnee = torch.where(ok_nee, _mis(pdf_nee, f_pdf), 0.0)
    # f and W carry inf/NaN on miss lanes (t = inf): the where wraps the
    # whole product, not just the weight
    Lr = Lr + Br * torch.where(ok_nee, fr_nee * wnee * Wr_nee, 0.0)
    Lg = Lg + Bg * torch.where(ok_nee, fg_nee * wnee * Wg_nee, 0.0)
    Lb = Lb + Bb * torch.where(ok_nee, fb_nee * wnee * Wb_nee, 0.0)

    # ---- BSDF sampling: cosine hemisphere (SmoothDiffuse.sample) ----
    ub = rng.sample_2d(seed, lane, dbase + SLOT_BSDF_DIR)
    dxl, dyl, dzl = warp.square_to_cosine_hemisphere(ub).unbind(-1)
    ndx = sx * dxl + tx * dyl + shx * dzl
    ndy = sy * dxl + ty * dyl + shy * dzl
    ndz = sz * dxl + tz * dyl + shz * dzl
    pdf_fwd = INV_PI * dzl
    Br = torch.where(act_next, Br * Rr, Br)
    Bg = torch.where(act_next, Bg * Rg, Bg)
    Bb = torch.where(act_next, Bb * Rb, Bb)
    bmax = torch.maximum(Br, torch.maximum(Bg, Bb))
    act_next = act_next & (pdf_fwd > 0.0) & (bmax > 0.0)
    sgn_b = torch.where(ndx * ngx + ndy * ngy + ndz * ngz >= 0.0, 1.0, -1.0)
    ox = px + sgn_b * off * ngx
    oy = py + sgn_b * off * ngy
    oz = pz + sgn_b * off * ngz
    prev_pdf = torch.where(act_next, pdf_fwd, prev_pdf)
    prev_delta = prev_delta & ~act_next

    # ---- russian roulette (path.py:117-128); eta_acc is 1 for diffuse ----
    if depth + 1 >= rr_depth:
        rr_p = torch.clamp(bmax, max=0.95)
        u_rr = rng.sample_1d(seed, lane, dbase + SLOT_RR)
        survive = u_rr < rr_p
        inv_p = 1.0 / torch.clamp(rr_p, min=1e-8)
        Br = torch.where(act_next, Br * inv_p, Br)
        Bg = torch.where(act_next, Bg * inv_p, Bg)
        Bb = torch.where(act_next, Bb * inv_p, Bb)
        act_next = act_next & survive
    return (ox, oy, oz, ndx, ndy, ndz, Lr, Lg, Lb, Br, Bg, Bb, eta,
            prev_pdf, prev_delta, act_next)
