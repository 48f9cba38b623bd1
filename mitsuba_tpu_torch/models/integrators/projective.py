"""Projective (visibility-discontinuity) gradients: the primary
silhouette boundary term and the shadow-boundary term
(mitsuba_tpu/models/integrators/projective.py; reference
src/python/python/ad/projective.py, integrators/prb_projective.py and
direct_projective.py).

PRB's detached estimator ignores moving visibility boundaries.  The
missing term is a line integral over the silhouette curves of

    (L_inner - L_outer) x (screen velocity of the boundary point),

estimated here by explicit edge sampling of the scene's meshes (the edge
set built once on the host, ``build_silhouette_edges``).  Each boundary
sample contributes the scalar

    S = sum_k  c_k * (m_k . u_k(theta))

where u_k is the attached film position of the edge point (through the
mesh vertices and the camera pose), m_k the detached film-space edge
normal and c_k = <delta_image, dL> x (film-length Jacobian) / pdf, all
detached.  ``torch.autograd.grad`` of S gives the boundary term of every
float leaf; flipping m flips both the velocity and the radiance
difference, so no sign bookkeeping is needed.  dL = L(-m side) -
L(+m side): moving the boundary along +m grows the -m side's region.

Ported: the primarily visible silhouettes, uniform or grid-guided
(``guiding.py``), and the shadow (indirect-visibility) term
``indirect_boundary_grads``: the light->edge->receiver construction of
``_shadow_pass``, whose boundary point x_B on the receiver is seen from
the camera (a ptracer-style connection) and, with ``indirect_depth`` k,
from every vertex of a detached camera prefix of up to k - 1 bounces;
sampled uniformly over its (u_edge, t, u_light) cube, from the
``OcSpaceDistr`` octree learnt in a warm-up pass (``"octree"``), or from
an octree whose warm-up starts at silhouettes that ``projection.py``'s
hybrid projection walked light-side rays onto (``"projective"``).  Each
shadow sample's S term re-attaches x_B through the blocker's edge, the
light point and the receiver's plane, and re-projects it onto the
detached plane along the viewer's ray, so a moving receiver gets its
term too.  A receiver that is an analytic prim keeps its detached
tangent plane (the JAX package's comment at projective.py:720-721, which
its code misses: it takes mesh face 0's plane); a scene lit by an
analytic sphere gets no shadow term, logged (JAX builds an empty
light-face set there and raises).  ``analytic_boundary_grads`` adds the
exact silhouettes of analytic spheres (their contour, which moves with
the camera and the sphere) and disks (their rim) in closed form.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.autograd.forward_ad as fwad

from ...core import rng
from ...core.math import coordinate_system, cross, dot, sqrt, via_f64
from ...core.records import Ray
from ...utils.params import float_leaves, update
from ..emitters import AreaEmitter
from ..textures import ConstantTexture
from .common import DIM_APERTURE, DIM_WAVELENGTH, check_device
from .guiding import GridDistr, OcSpaceDistr, UniformDistr
from .path import PathIntegrator
from .prb import PRBIntegrator, _adjoint, _detached, _duals, _primal_image
from .projection import (build_face_adjacency, light_faces, light_point,
                         project_seed_points)

# RNG dimension block for boundary sampling (disjoint from path dims)
DIM_B_EDGE = 8192
DIM_B_T = 8193
DIM_B_SUB = 8200

# the JAX package's int32 lane offsets; lanes wrap as int32 there, so
# here they are int64 masked to 32 bits (core/rng.py reads the same bits)
_PASS_SALT = 104729
_SUB_SALT = 7919
_MINUS_SALT = 31337
_SEED_SALT = 0x5EED0B0D
# the shadow term's seed salts (uint32 XORs, as the JAX package's): a
# pass, the octree's warm-up pass, the projection's seeds and the
# uniform points that replace its failed seeds
_SHADOW_SALT = 0x1D1BEC7
_WARMUP_SALT = 0x5EED0C7
_PROJECTION_SALT = 0x11A2B3
_FALLBACK_SALT = 0x77AB12
# the analytic silhouettes' seed salt (a uint32 XOR)
_ANALYTIC_SALT = 0x51171E77
# the depth-k prefixes' connection guards (projective.py:656-667): the
# viewers grazing the receiver's plane, the connections shorter than
# this share of the scene's radius
_GRAZE_TAU = 2e-2
_R_MIN_FRAC = 1e-3

_log = logging.getLogger(__name__)


@dataclass
class EdgeTable:
    """Unique mesh edges with their adjacent faces (host-built, static
    topology), int64 tensors on the scene's device."""

    v0: torch.Tensor    # (E,) vertex ids (global)
    v1: torch.Tensor    # (E,)
    f0: torch.Tensor    # (E,) adjacent face
    f1: torch.Tensor    # (E,) second face or -1 (open boundary)


def build_silhouette_edges(scene) -> EdgeTable:
    """The unique edge set of the scene's global face table, with the
    JAX package's order and second-face rule (projective.py:74-97)."""
    f = scene.geometry()[1].cpu().numpy()
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    face_id = np.tile(np.arange(f.shape[0], dtype=np.int64), 3)
    key = np.sort(e, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    key = key[order]
    face_id = face_id[order]
    new = np.ones(key.shape[0], bool)
    new[1:] = np.any(key[1:] != key[:-1], axis=1)
    first = np.nonzero(new)[0]
    # the second adjacent face, if the next row shares the key
    nxt = np.minimum(first + 1, key.shape[0] - 1)
    has2 = (nxt != first) & ~new[nxt]
    cols = (key[first, 0], key[first, 1], face_id[first],
            np.where(has2, face_id[nxt], -1))
    return EdgeTable(*(torch.as_tensor(c, dtype=torch.int64,
                                       device=scene.device) for c in cols))


def _face_normals(verts, faces):
    p0 = verts[faces[:, 0]]
    n = cross(verts[faces[:, 1]] - p0, verts[faces[:, 2]] - p0)
    return n / sqrt(torch.clamp(dot(n, n, keepdim=True), min=1e-20))


def _project(sensor, x, active):
    """World points -> (film uv (N, 2) in pixels, valid, camera point),
    through the sensor's connection ``sample_direction``."""
    n = x.shape[0]
    ds, w = sensor.sample_direction(
        x, torch.full((n, 2), 0.5, device=x.device), active)
    valid = active & (ds.pdf > 0.0) & (w != 0.0).any(dim=-1)
    return ds.uv, valid, ds.p


def _radiance_at(scene_det, integrator, film_pos, lane, seed, active,
                 n_sub: int):
    """Mean radiance of ``n_sub`` paths through each film position
    (projective.py:117-131): sub-path k of a lane is the lane
    ``lane + (1 + k) * 7919``.  The n_sub walks go as one wavefront,
    each lane's walk the same as alone."""
    sensor = scene_det.sensor
    n = film_pos.shape[0]
    pos_unit = film_pos / torch.tensor(
        [sensor.film.width, sensor.film.height], dtype=torch.float32,
        device=film_pos.device)
    lanes = torch.cat([(lane + (1 + k) * _SUB_SALT) & rng.MASK32
                       for k in range(n_sub)])
    wav = rng.sample_1d(seed, lanes, DIM_WAVELENGTH)
    ap = rng.sample_2d(seed, lanes, DIM_APERTURE)
    ray, wgt = sensor.sample_ray(None, wav, pos_unit.repeat(n_sub, 1), ap)
    Lk = (integrator.sample(scene_det, ray, lanes, seed, active.repeat(n_sub))
          * wgt).reshape(n_sub, n, 3)
    L = torch.zeros((n, 3), device=film_pos.device)
    for k in range(n_sub):
        L = L + Lk[k]
    return L / n_sub


def _filter_mass(rfilter, n: int, device):
    """F(i) = the filter's integral over the film's [0, n) around pixel
    centre i + 0.5, along one axis (midpoint rule, 256 points a pixel):
    one axis of the expected filter weight a pixel gathers from one
    sample a pixel."""
    r = float(rfilter.radius)
    k = max(1, int(math.ceil(512 * r)))
    offs = (torch.arange(k, dtype=torch.float32, device=device) + 0.5) \
        * (2.0 * r / k) - r
    x = torch.arange(n, dtype=torch.float32, device=device)[:, None] + 0.5 \
        + offs
    inside = (x >= 0.0) & (x < n)
    return torch.sum(torch.where(inside, rfilter.eval_1d(offs)[None, :], 0.0),
                     dim=1) * (2.0 * r / k)


def _film_adjoint(film, grad_image, uv):
    """How much <grad_image, image> moves, per unit of film area, when the
    radiance at film positions uv (N, 2) changes: the image is the
    weight-normalised splat, so that is the sum over the filter's taps
    of grad_image[p] f(c_p - u) / F_p, F_p the weight pixel p expects
    from one sample a pixel (``_filter_mass``).  For the box filter it
    is grad_image at the pixel under u, which is what the JAX package
    reads whatever the filter (projective.py:200-206): under another
    filter (the Cornell box's gaussian) its boundary term is biased
    (ROADMAP.md Queue 3)."""
    h, w = film.height, film.width
    px = torch.clamp(torch.floor(uv[:, 0]).to(torch.int64), 0, w - 1)
    py = torch.clamp(torch.floor(uv[:, 1]).to(torch.int64), 0, h - 1)
    rf = film.rfilter
    if rf.kind == "box":
        return grad_image[py, px]
    fx = _filter_mass(rf, w, uv.device)
    fy = _filter_mass(rf, h, uv.device)
    r = max(1, int(math.ceil(rf.radius)))
    out = torch.zeros((uv.shape[0], grad_image.shape[-1]), device=uv.device)
    for dy in range(-r, r + 1):
        y = py + dy
        ok_y = (y >= 0) & (y < h)
        y = torch.clamp(y, 0, h - 1)
        wy = torch.where(ok_y, rf.eval_1d(y + 0.5 - uv[:, 1]) / fy[y], 0.0)
        for dx in range(-r, r + 1):
            x = px + dx
            ok_x = (x >= 0) & (x < w)
            x = torch.clamp(x, 0, w - 1)
            wx = torch.where(ok_x, rf.eval_1d(x + 0.5 - uv[:, 0]) / fx[x],
                             0.0)
            out = out + (wy * wx)[:, None] * grad_image[y, x]
    return out


@dataclass
class _Edges:
    """The detached per-edge geometry one backward's passes share."""

    table: EdgeTable
    p0: torch.Tensor        # (E, 3) the edges' end points
    p1: torch.Tensor
    lengths: torch.Tensor   # (E,)
    fn: torch.Tensor        # (F, 3) face normals


def _edge_geometry(scene_det, edges: EdgeTable) -> _Edges:
    verts, faces = scene_det.geometry()[:2]
    p0, p1 = verts[edges.v0], verts[edges.v1]
    return _Edges(edges, p0, p1,
                  sqrt(torch.clamp(dot(p1 - p0, p1 - p0), min=1e-20)),
                  _face_normals(verts, faces))


def _boundary_pass(scene_det, ctx, edges: _Edges, integrator, grad_image,
                   seed_b, distr, n_samples, n_sub, eps_px, pass_salt):
    """One pass of edge sampling (projective.py:157-214), detached:
    (edge index, t, film-space edge normal m_hat, coefficient c, valid),
    m_hat zero where the sample is not valid."""
    sensor = scene_det.sensor
    film = sensor.film
    dev = edges.lengths.device
    tab = edges.table
    lane = (torch.arange(n_samples, dtype=torch.int64, device=dev)
            + pass_salt * _PASS_SALT) & rng.MASK32
    u_e = rng.sample_1d(seed_b, lane, DIM_B_EDGE)
    t = rng.sample_1d(seed_b, lane, DIM_B_T)
    idx, pmf = distr.sample(u_e)
    p0, p1 = edges.p0[idx], edges.p1[idx]
    x = p0 * (1.0 - t[:, None]) + p1 * t[:, None]
    active = torch.ones(n_samples, dtype=torch.bool, device=dev)

    uv, valid, cam_p = _project(sensor, x, active)
    d = x - cam_p
    dist = sqrt(torch.clamp(dot(d, d), min=1e-20))
    d = d / dist[:, None]

    # silhouette classification (open edges always qualify)
    c0 = dot(edges.fn[tab.f0[idx]], d)
    c1 = dot(edges.fn[torch.clamp(tab.f1[idx], min=0)], d)
    sil = (c0 * c1 < 0.0) | (tab.f1[idx] < 0)

    # visibility from the camera: the edge point must be the first hit
    # (a pinhole's camera point is one row expanded; the queries take
    # contiguous rays)
    occluded = scene_det.ray_test(
        Ray(o=cam_p.contiguous(), d=d, maxt=dist * (1.0 - 1e-3)), valid, ctx)
    valid = valid & sil & ~occluded

    # film-space edge tangent (the projection's JVP) and normal
    edir = (p1 - p0) / edges.lengths[idx][:, None]
    with fwad.dual_level():
        du_dl = fwad.unpack_dual(
            _project(sensor, fwad.make_dual(x, edir), active)[0]).tangent
    speed = sqrt(torch.clamp(dot(du_dl, du_dl), min=1e-20))
    m_hat = torch.stack([-du_dl[:, 1], du_dl[:, 0]], -1) / speed[:, None]

    # the radiance difference across the edge: -m side minus +m side,
    # both sides in one wavefront
    L = _radiance_at(scene_det, integrator,
                     torch.cat([uv + eps_px * m_hat, uv - eps_px * m_hat]),
                     torch.cat([lane, (lane + _MINUS_SALT) & rng.MASK32]),
                     seed_b, torch.cat([valid, valid]), n_sub)
    dL = L[n_samples:] - L[:n_samples]

    # the adjoint of the film at the edge point
    delta = _film_adjoint(film, grad_image, uv)

    inv_pdf = edges.lengths[idx] / torch.clamp(pmf, min=1e-20)
    coeff = torch.where(valid, torch.sum(delta * dL, -1) * speed * inv_pdf
                        / n_samples, 0.0)
    return idx, t, torch.where(valid[:, None], m_hat, 0.0), coeff, valid


def _boundary_backward(scene_det, table: EdgeTable, idx, t, weight, params):
    """{path: gradient} of S = sum(weight . uv_att) for the leaves
    ``params``: the scene rebuilt around fresh leaves, the sampled edge
    points re-projected attached.  ``weight`` (N, 2) = c * m_hat, zero
    on invalid lanes, so a parked lane's NaN cannot reach the sum."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        sc = update(scene_det, leaves)
        v_att = sc.geometry()[0]
        x_att = (v_att[table.v0[idx]] * (1.0 - t[:, None])
                 + v_att[table.v1[idx]] * t[:, None])
        uv_att, _, _ = _project(sc.sensor, x_att, torch.ones(
            x_att.shape[0], dtype=torch.bool, device=x_att.device))
        s = torch.sum(weight * torch.nan_to_num(uv_att))
        g = (torch.autograd.grad(s, list(leaves.values()), allow_unused=True)
             if s.requires_grad else [None] * len(leaves))
    return {k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g)}


def primary_boundary_grads(scene, edges: EdgeTable, integrator, grad_image,
                           seed, n_samples: int = 4096, n_sub: int = 4,
                           eps_px: float = 0.75, guiding: str = "grid",
                           params=None):
    """Boundary-term gradients {path: gradient} of sum(grad_image *
    image) for the float leaves ``params`` ({path: tensor}, default all
    of the scene's), from the primarily visible silhouettes
    (projective.py:134-237).  Every guiding mode but "uniform" first
    runs a warm-up pass (pass salt 1) into a ``GridDistr``, then the
    main pass (salt 0) samples from it."""
    if params is None:
        params = float_leaves(scene)
    scene_det = _detached(scene)
    seed_b = (int(seed) & rng.MASK32) ^ _SEED_SALT
    with torch.no_grad():
        ctx = scene_det.trace_ctx()
        geo = _edge_geometry(scene_det, edges)

        def one_pass(distr, pass_salt):
            return _boundary_pass(scene_det, ctx, geo, integrator, grad_image,
                                  seed_b, distr, n_samples, n_sub, eps_px,
                                  pass_salt)

        if guiding != "uniform":
            warm = GridDistr.create(geo.lengths)
            idx_w, _, _, coeff_w, _ = one_pass(warm, 1)
            distr = warm.update(idx_w, torch.abs(coeff_w)).finalize()
        else:
            distr = UniformDistr.create(geo.lengths)
        idx, t, m_hat, coeff, _ = one_pass(distr, 0)
    return _boundary_backward(scene_det, edges, idx, t,
                              coeff[:, None] * m_hat, params)


# ------------------------------------------ the analytic silhouettes

def _contour_points(an, theta, idx, cam_o):
    """The closed-form silhouette point of each lane's curve ``idx``
    (spheres first, then disks) at angle ``theta`` (projective.py:279-307):
    a sphere's contour circle as seen from the camera point ``cam_o``,

        z = (o - c) / D,  cos_b = r / D,
        x = c + r (cos_b z + sin_b (cos(theta) s + sin(theta) t)),

    or a disk's rim c + su cos(theta) + sv sin(theta)."""
    cos_t = via_f64(torch.cos, theta)[:, None]
    sin_t = via_f64(torch.sin, theta)[:, None]
    nS, nD = an.n_spheres, an.n_disks
    out = None
    if nS:
        j = torch.clamp(idx, 0, nS - 1)
        c, r = an.sp_center[j], an.sp_radius[j]
        oc = cam_o - c
        D = sqrt(torch.clamp(dot(oc, oc), min=1e-20))
        z = oc / D[:, None]
        cos_b = torch.clamp(r / D, 0.0, 1.0 - 1e-6)
        sin_b = sqrt(torch.clamp(1.0 - cos_b * cos_b, min=1e-12))
        s, t = coordinate_system(z)
        out = c + r[:, None] * (cos_b[:, None] * z
                                + sin_b[:, None] * (s * cos_t + t * sin_t))
    if nD:
        j = torch.clamp(idx - nS, 0, nD - 1)
        x_d = an.dk_center[j] + an.dk_su[j] * cos_t + an.dk_sv[j] * sin_t
        out = x_d if out is None else torch.where((idx >= nS)[:, None], x_d,
                                                  out)
    return out


def _prim_centres(an, idx):
    """The centre of each lane's curve's prim (sphere or disk)."""
    nS, nD = an.n_spheres, an.n_disks
    if not nD:
        return an.sp_center[idx]
    disk = an.dk_center[torch.clamp(idx - nS, 0, nD - 1)]
    if not nS:
        return disk
    return torch.where((idx < nS)[:, None],
                       an.sp_center[torch.clamp(idx, 0, nS - 1)], disk)


@dataclass
class _ContourSamples:
    """One pass of the analytic silhouettes, detached, (N, ...)."""

    idx: torch.Tensor       # (N,) the curve: sphere j < S, disk S + j
    theta: torch.Tensor     # (N,) the angle along it
    m_hat: torch.Tensor     # (N, 2) its film-space normal, 0 off valid
    coeff: torch.Tensor     # (N,) zero where the lane adds nothing


def _contour_pass(scene_det, integrator, grad_image, seed_b, n_samples,
                  n_sub, eps_px):
    """The detached samples of ``analytic_boundary_grads``
    (projective.py:268-367): a curve uniformly (pmf 1 / (S + D)), theta
    uniform, the point's tangent by forward-mode AD, the camera's
    visibility of the point pushed 0.1 % off its prim's centre, the
    radiance difference across the curve from both sides' walks in one
    wavefront, and the film's adjoint at the point (``_film_adjoint``)."""
    an, sensor = scene_det.scene_analytic, scene_det.sensor
    dev = an.device
    n_curves = an.n_spheres + an.n_disks
    lane = torch.arange(n_samples, dtype=torch.int64, device=dev)
    u_c = rng.sample_1d(seed_b, lane, DIM_B_EDGE)
    u_t = rng.sample_1d(seed_b, lane, DIM_B_T)
    idx = torch.clamp((u_c * n_curves).to(torch.int64), 0, n_curves - 1)
    theta = u_t * (2.0 * math.pi)
    cam_o = sensor.to_world[:3, 3].expand(n_samples, 3)
    with fwad.dual_level():
        x, dx_dth = fwad.unpack_dual(_contour_points(
            an, fwad.make_dual(theta, torch.ones_like(theta)), idx, cam_o))
    speed_w = sqrt(torch.clamp(dot(dx_dth, dx_dth), min=1e-20))
    edir = dx_dth / speed_w[:, None]
    every = torch.ones(n_samples, dtype=torch.bool, device=dev)
    uv, valid, cam_p = _project(sensor, x, every)

    # the camera's visibility of the point, pushed off its prim so that
    # the grazing ray does not hit the prim itself
    ctr = _prim_centres(an, idx)
    d_t = ctr + (x - ctr) * 1.001 - cam_p
    dist_t = sqrt(torch.clamp(dot(d_t, d_t), min=1e-20))
    occluded = scene_det.ray_test(
        Ray(o=cam_p.contiguous(), d=d_t / dist_t[:, None],
            maxt=dist_t * (1.0 - 2e-3)), valid, scene_det.trace_ctx())
    valid = valid & ~occluded

    # the film-space tangent of the curve and its normal
    with fwad.dual_level():
        du_dl = fwad.unpack_dual(
            _project(sensor, fwad.make_dual(x, edir), every)[0]).tangent
    speed = sqrt(torch.clamp(dot(du_dl, du_dl), min=1e-20))
    m_hat = torch.stack([-du_dl[:, 1], du_dl[:, 0]], -1) / speed[:, None]

    # the radiance difference, -m side minus +m side, in one wavefront
    L = _radiance_at(scene_det, integrator,
                     torch.cat([uv + eps_px * m_hat, uv - eps_px * m_hat]),
                     torch.cat([lane, (lane + _MINUS_SALT) & rng.MASK32]),
                     seed_b, torch.cat([valid, valid]), n_sub)
    dL = L[n_samples:] - L[:n_samples]
    delta = _film_adjoint(sensor.film, grad_image, uv)
    # the curve-length pdf: theta uniform -> pmf / (2 pi |dx / dtheta|)
    inv_pdf = (2.0 * math.pi) * speed_w * n_curves
    coeff = torch.where(valid, torch.sum(delta * dL, -1) * speed * inv_pdf
                        / n_samples, 0.0)
    return _ContourSamples(idx, theta, torch.where(valid[:, None], m_hat, 0.0),
                           coeff)


def _contour_terms(sc, s: _ContourSamples, keep):
    """S's terms c * (m_hat . uv) on the lanes ``keep`` of the scene
    ``sc``: the contour points re-attached through the prims and the
    camera point, projected through the attached sensor."""
    cam_o = sc.sensor.to_world[:3, 3].expand(keep.shape[0], 3)
    x = _contour_points(sc.scene_analytic, s.theta[keep], s.idx[keep], cam_o)
    uv = torch.nan_to_num(_project(sc.sensor, x, torch.ones(
        x.shape[0], dtype=torch.bool, device=x.device))[0])
    return s.coeff[keep] * dot(s.m_hat[keep], uv)


def analytic_boundary_grads(scene, integrator, grad_image, seed,
                            n_samples: int = 2048, n_sub: int = 4,
                            eps_px: float = 0.75, params=None):
    """Exact silhouette gradients {path: gradient} of sum(grad_image *
    image) for the float leaves ``params`` (default all of the scene's)
    from its analytic spheres' contours and disks' rims
    (projective.py:240-383; the reference's sample_silhouette of
    sphere.cpp:383-475 and disk.cpp:235-330), without the tessellation's
    bias.  A sphere's contour moves with the camera and the sphere, so S
    re-attaches the whole closed form, and its gradient carries the shift
    of the contour generator.  Cylinders add no term, as in the JAX
    package.  The adjoint is weighted by the film's filter
    (``_film_adjoint``), where the JAX package reads one pixel."""
    if params is None:
        params = float_leaves(scene)
    scene_det = _detached(scene)
    seed_b = (int(seed) & rng.MASK32) ^ _ANALYTIC_SALT
    an = scene_det.scene_analytic
    if an is None or an.n_spheres + an.n_disks == 0:
        return {k: torch.zeros_like(v) for k, v in params.items()}
    with torch.no_grad():
        s = _contour_pass(scene_det, integrator, grad_image, seed_b,
                          n_samples, n_sub, eps_px)
    keep = torch.nonzero(s.coeff != 0.0).squeeze(1)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        total = torch.sum(_contour_terms(update(scene_det, leaves), s, keep))
        g = (torch.autograd.grad(total, list(leaves.values()),
                                 allow_unused=True)
             if total.requires_grad else [None] * len(leaves))
    return {k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g)}


# ------------------------------------------------------ the shadow term

@dataclass
class _ShadowSamples:
    """One shadow pass, detached: each lane's cube point, its
    coefficients (the camera connection's, then each prefix depth's) and
    what S's backward re-attaches, all (N, ...)."""

    points: torch.Tensor    # (N, 3) (u_edge, t, u_light)
    coeffs: list            # [(N,)] zero where the lane adds nothing
    viewers: list           # [(N, 3)] the camera point, then x_2 .. x_k
    edge: torch.Tensor      # (N,) EdgeTable row of the edge point
    t: torch.Tensor         # (N,) its position along the edge
    light: torch.Tensor     # (N, 3) the light face's vertex ids
    b0: torch.Tensor        # (N,) the light point's barycentrics
    b1: torch.Tensor
    recv: torch.Tensor      # (N, 3) the receiver face's vertex ids
    mesh_recv: torch.Tensor  # (N,) the receiver is a mesh face, not a prim
    p_recv: torch.Tensor    # (N, 3) x_B
    n_recv: torch.Tensor    # (N, 3) the receiver's geometric normal
    m_hat: torch.Tensor     # (N, 3) the boundary curve's in-plane normal

    def mass(self):
        """Each lane's |contribution|, summed over its terms: what the
        octree learns from."""
        mass = torch.abs(self.coeffs[0])
        for c in self.coeffs[1:]:
            mass = mass + torch.abs(c)
        return mass


def _shadow_pass(scene_det, ctx, geo: _Edges, lights, grad_image, seed,
                 n_samples, eps_frac, indirect_depth, oc=None, points=None,
                 collect=False):
    """One pass of the shadow term (projective.py:451-716), detached.
    ``oc`` importance-samples the (u_edge, t, u_light) cube; ``points``
    (N, 3) evaluates the integrand at given cube points instead (the
    projection-seeded warm-up).  Returns the ``_ShadowSamples``, or with
    ``collect`` only (points, mass), the warm-up's product."""
    sensor = scene_det.sensor
    film = sensor.film
    w_px, h_px = film.width, film.height
    dev = geo.lengths.device
    tab = geo.table
    light_shape = scene_det.emitter_shape[0]
    le = scene_det.emitters[0].radiance.value     # constant radiance
    lf, lv0, lv1, lv2, lareas = lights
    A_L = torch.sum(lareas)
    lane = torch.arange(n_samples, dtype=torch.int64, device=dev)
    seed_b = (int(seed) & rng.MASK32) ^ _SHADOW_SALT
    every = torch.ones(n_samples, dtype=torch.bool, device=dev)

    # ---- the cube point: the light point y and the edge point x_e
    inv_oc = torch.ones(n_samples, device=dev)
    if points is not None:
        u_e, t_e, u_lf = points.unbind(-1)
    elif oc is not None:
        q, pdf_oc = oc.sample(
            rng.sample_1d(seed_b, lane, DIM_B_SUB + 3),
            torch.stack([rng.sample_1d(seed_b, lane, DIM_B_SUB + 4 + k)
                         for k in range(3)], dim=-1))
        inv_oc = 1.0 / torch.clamp(pdf_oc, min=1e-12)
        u_e, t_e, u_lf = q.unbind(-1)
    else:
        u_e = rng.sample_1d(seed_b, lane, DIM_B_EDGE)
        t_e = rng.sample_1d(seed_b, lane, DIM_B_T)
        u_lf = rng.sample_1d(seed_b, lane, DIM_B_SUB)
    lidx, _ = UniformDistr.create(lareas).sample(u_lf)
    y, n_y, b0, b1 = light_point(lv0, lv1, lv2, lidx,
                                 rng.sample_2d(seed_b, lane, DIM_B_SUB + 1))
    idx, pmf = UniformDistr.create(geo.lengths).sample(u_e)
    p0, p1 = geo.p0[idx], geo.p1[idx]
    x_e = p0 * (1.0 - t_e[:, None]) + p1 * t_e[:, None]

    d_ye = x_e - y
    dist_e = sqrt(torch.clamp(dot(d_ye, d_ye), min=1e-20))
    d_ye = d_ye / dist_e[:, None]
    # the edge must be a silhouette as seen from y, the light must face
    # it, and the segment y -> x_e must be clear
    c0 = dot(geo.fn[tab.f0[idx]], d_ye)
    c1 = dot(geo.fn[torch.clamp(tab.f1[idx], min=0)], d_ye)
    sil = (c0 * c1 < 0.0) | (tab.f1[idx] < 0)
    emit_ok = dot(d_ye, n_y) > 1e-6
    occ_e = scene_det.ray_test(
        Ray(o=y + d_ye * 1e-4, d=d_ye, maxt=dist_e * (1.0 - 1e-3)), every, ctx)
    valid = sil & emit_ok & ~occ_e

    # ---- the receiver: the continuation's hit past the edge
    o = x_e + d_ye * (1e-3 * dist_e[:, None] + 1e-4)
    si_r = scene_det.ray_intersect(
        Ray(o=o, d=d_ye, maxt=torch.full_like(dist_e, math.inf)), valid, ctx)
    valid = valid & si_r.is_valid() & (si_r.shape_index != light_shape)
    x_b = si_r.p
    r_tot = sqrt(torch.clamp(dot(x_b - y, x_b - y), min=1e-20))
    valid_b = valid          # the boundary's validity, before the camera's

    # ---- the camera connection, ptracer style
    uv, in_frustum, cam_p = _project(sensor, x_b, valid)
    d_cam = cam_p - x_b
    dist_c = sqrt(torch.clamp(dot(d_cam, d_cam), min=1e-20))
    d_cam = d_cam / dist_c[:, None]
    off = 1e-4 * torch.clamp(x_b.abs().amax(-1, keepdim=True), min=1.0)
    sgn_c = torch.sign(dot(d_cam, si_r.n, keepdim=True))
    occ_cam = scene_det.ray_test(
        Ray(o=x_b + sgn_c * off * si_r.n, d=d_cam, maxt=dist_c * (1.0 - 1e-3)),
        valid, ctx)
    valid = valid & in_frustum & ~occ_cam
    ds_cam, sw = sensor.sample_direction(
        x_b, torch.full((n_samples, 2), 0.5, device=dev), valid)
    # the adjoint BSDF at the receiver: wi from the light, wo to the camera
    f_val, _ = scene_det.bsdf_eval_pdf(si_r, si_r.to_local(ds_cam.d), valid)

    # ---- the receiver curve's tangent and normal, the edge-length
    # Jacobian: x_B moved along the edge, on the receiver's plane
    edir = (p1 - p0) / geo.lengths[idx][:, None]
    n_recv = si_r.n

    def to_receiver(xe):
        d = xe - y
        dn = dot(d, n_recv)
        tau = dot(x_b - y, n_recv) / torch.where(dn.abs() > 1e-9, dn, 1e-9)
        return y + tau[:, None] * d

    with fwad.dual_level():
        dxb_dl = fwad.unpack_dual(
            to_receiver(fwad.make_dual(x_e, edir))).tangent
    speed = sqrt(torch.clamp(dot(dxb_dl, dxb_dl), min=1e-20))
    m_hat = cross(n_recv, dxb_dl / speed[:, None])
    m_hat = m_hat / sqrt(torch.clamp(dot(m_hat, m_hat, keepdim=True),
                                     min=1e-20))

    # ---- the visibility difference across the curve, both sides in one
    # query
    eps = float(np.float32(eps_frac)
                * np.float32(max(scene_det.scene_radius, 1e-3)))
    xp = torch.cat([x_b + eps * m_hat, x_b - eps * m_hat])
    d = y.repeat(2, 1) - xp
    dist = sqrt(torch.clamp(dot(d, d), min=1e-20))
    dn = d / dist[:, None]
    n2 = n_recv.repeat(2, 1)
    sgn_v = torch.sign(dot(dn, n2, keepdim=True))
    occ = scene_det.ray_test(
        Ray(o=xp + sgn_v * off.repeat(2, 1) * n2, d=dn,
            maxt=dist * (1.0 - 2e-3)), valid_b.repeat(2), ctx)
    vis = 1.0 - occ.to(torch.float32)
    dV = vis[:n_samples] - vis[n_samples:]

    # ---- the detached coefficients
    cos_xy = torch.abs(dot((y - x_b) / r_tot[:, None], n_recv))
    G = cos_xy * torch.abs(dot(d_ye, n_y)) / torch.clamp(r_tot ** 2,
                                                         min=1e-12)
    inv_pdf = geo.lengths[idx] / torch.clamp(pmf, min=1e-20)

    def coefficient(ok, transport):
        # the transport sign: dI = -(V_plus - V_minus) F v; the ptracer
        # measure identity I_p = (W H) E[value 1{p}] gives the pixel factor
        return torch.where(ok, -(w_px * h_px) * transport * G * dV * speed
                           * inv_pdf * A_L * inv_oc / n_samples, 0.0)

    delta = _film_adjoint(film, grad_image, uv)
    coeffs = [coefficient(valid, dot(delta * sw * f_val, le.expand_as(sw)))]
    viewers = [cam_p]

    # ---- the deeper camera prefixes (projective.py:629-716): x_B seen
    # through j - 1 more bounces, j = 2 .. indirect_depth.  The prefix is
    # a detached walk from a uniform film position; every prefix vertex
    # x_j connects to x_B, so each sample lands on a surface the camera
    # sees and reads the adjoint at its own film position.  The guards
    # cull the connection's two log-divergent tails: viewers grazing the
    # receiver's plane (view_on_plane's 1 / cos) and near-zero radii.
    if indirect_depth >= 2:
        u_px = rng.sample_2d(seed_b, lane, DIM_B_SUB + 7)
        cam_ray, _ = sensor.sample_ray(
            None, torch.zeros(n_samples, device=dev), u_px,
            rng.sample_2d(seed_b, lane, DIM_B_SUB + 8))
        si_j = scene_det.ray_intersect(cam_ray, valid_b, ctx)
        ok_walk = valid_b & si_j.is_valid() & (si_j.shape_index != light_shape)
        tput_walk = torch.ones((n_samples, 3), device=dev)
        delta2 = _film_adjoint(film, grad_image, u_px * torch.tensor(
            [w_px, h_px], dtype=torch.float32, device=dev))
        r_min = _R_MIN_FRAC * float(scene_det.scene_radius)
        for j in range(2, indirect_depth + 1):
            d_2b = x_b - si_j.p
            r2b = sqrt(torch.clamp(dot(d_2b, d_2b), min=1e-20))
            d_2b = d_2b / r2b[:, None]
            # the visibility x_j -> x_B
            off2 = 1e-4 * torch.clamp(si_j.p.abs().amax(-1, keepdim=True),
                                      min=1.0)
            sg2 = torch.sign(dot(d_2b, si_j.n, keepdim=True))
            occ2 = scene_det.ray_test(
                Ray(o=si_j.p + sg2 * off2 * si_j.n, d=d_2b,
                    maxt=r2b * (1.0 - 2e-3)), ok_walk, ctx)
            cos_view = torch.abs(dot(d_2b, n_recv))
            ok2 = ok_walk & ~occ2 & (cos_view > _GRAZE_TAU) & (r2b > r_min)
            # f at x_j (wi from the previous vertex, wo to x_B) and at x_B
            # (wi from the light, wo to x_j), each with its cosine
            f_2, _ = scene_det.bsdf_eval_pdf(si_j, si_j.to_local(d_2b), ok2)
            f_b, _ = scene_det.bsdf_eval_pdf(si_r, si_r.to_local(-d_2b), ok2)
            tput2 = dot(delta2 * tput_walk * f_2 * f_b, le.expand_as(f_b)) \
                / torch.clamp(r2b * r2b, min=1e-12)
            coeffs.append(coefficient(ok2, tput2))
            viewers.append(si_j.p)
            if j < indirect_depth:
                # one more bounce of the prefix: detached BSDF sampling
                # from fresh dimensions at each depth
                bs, w_b = scene_det.bsdf_sample(
                    si_j, rng.sample_1d(seed_b, lane, DIM_B_SUB + 16 + 3 * j),
                    rng.sample_2d(seed_b, lane, DIM_B_SUB + 17 + 3 * j),
                    ok_walk)
                wo_w = si_j.to_world(bs.wo)
                sgb = torch.sign(dot(wo_w, si_j.n, keepdim=True))
                o = si_j.p + sgb * off2 * si_j.n
                ok_walk = ok_walk & (bs.pdf > 0.0)
                si_j = scene_det.ray_intersect(
                    Ray(o=o, d=wo_w, maxt=torch.full_like(r2b, math.inf)),
                    ok_walk, ctx)
                ok_walk = ok_walk & si_j.is_valid() \
                    & (si_j.shape_index != light_shape)
                tput_walk = tput_walk * w_b

    # a mesh face receives; an SDF, analytic prim or instance does not
    mesh_recv = si_r.shape_index < len(scene_det.meshes)
    samples = _ShadowSamples(
        points=torch.stack([u_e, t_e, u_lf], dim=-1), coeffs=coeffs,
        viewers=viewers, edge=idx, t=t_e, light=lf[lidx], b0=b0, b1=b1,
        recv=scene_det.geometry()[1][torch.where(mesh_recv, si_r.prim_index,
                                                 0)],
        mesh_recv=mesh_recv, p_recv=x_b,
        n_recv=n_recv, m_hat=m_hat)
    return (samples.points, samples.mass()) if collect else samples


def _shadow_terms(sc, table: EdgeTable, s: _ShadowSamples, keep):
    """S's terms (K, 1 + depths) on the lanes ``keep`` of the scene ``sc``
    (projective.py:726-773): x_B re-attached through the edge point, the
    light point and the receiver's plane (the receiver's motion: a mesh
    face's attached plane, an analytic prim's detached tangent plane),
    then re-projected onto the detached plane along each viewer's ray,
    which is what the previous path vertex sees (the identity at the
    current parameters, exact to first order)."""
    v = sc.geometry()[0]
    t_e, b0, b1 = s.t[keep], s.b0[keep], s.b1[keep]
    edge, light, recv = s.edge[keep], s.light[keep], s.recv[keep]
    xe = v[table.v0[edge]] * (1.0 - t_e[:, None]) \
        + v[table.v1[edge]] * t_e[:, None]
    y = (v[light[:, 0]] * (1.0 - b0 - b1)[:, None]
         + v[light[:, 1]] * b0[:, None] + v[light[:, 2]] * b1[:, None])
    # the plane's scale and orientation cancel in tau: the raw cross
    # product is its normal
    p_recv, n_recv, m_hat = s.p_recv[keep], s.n_recv[keep], s.m_hat[keep]
    mesh_recv = s.mesh_recv[keep][:, None]
    r0 = v[recv[:, 0]]
    nr = torch.where(mesh_recv, cross(v[recv[:, 1]] - r0, v[recv[:, 2]] - r0),
                     n_recv)
    r0 = torch.where(mesh_recv, r0, p_recv)
    d = xe - y
    dn = dot(d, nr)
    tau = dot(r0 - y, nr) / torch.where(dn.abs() > 1e-9, dn, 1e-9)
    xb = torch.nan_to_num(y + tau[:, None] * d)

    def view_on_plane(viewer):
        dv = xb - viewer
        den = dot(dv, n_recv)
        den = torch.where(den.abs() > 1e-9, den,
                          torch.where(den >= 0, 1e-9, -1e-9))
        return viewer + (dot(p_recv - viewer, n_recv) / den)[:, None] * dv

    return torch.stack([c[keep] * dot(m_hat, view_on_plane(w[keep]))
                        for c, w in zip(s.coeffs, s.viewers)], dim=-1)


def _contributing(s: _ShadowSamples):
    """The lanes with a nonzero coefficient: the rest add nothing to S,
    and a parked lane's undefined geometry must not reach its sum."""
    nz = s.coeffs[0] != 0.0
    for c in s.coeffs[1:]:
        nz = nz | (c != 0.0)
    return torch.nonzero(nz).squeeze(1)


def _shadow_backward(scene_det, table: EdgeTable, s: _ShadowSamples, params):
    """{path: gradient} of S = the sum of ``_shadow_terms`` for the leaves
    ``params``: the scene rebuilt around fresh leaves."""
    keep = _contributing(s)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        total = torch.sum(_shadow_terms(update(scene_det, leaves), table, s,
                                        keep))
        g = (torch.autograd.grad(total, list(leaves.values()),
                                 allow_unused=True)
             if total.requires_grad else [None] * len(leaves))
    return {k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g)}


def _shadow_tangents(scene_det, table: EdgeTable, s: _ShadowSamples,
                     tangents):
    """Each lane's directional derivative of its S terms along
    ``tangents`` ({path: tangent}), (N, 1 + depths): which samples carry
    the gradient."""
    keep = _contributing(s)
    out = torch.zeros((s.t.shape[0], len(s.coeffs)), device=s.t.device)
    with fwad.dual_level():
        sc = update(scene_det, _duals(float_leaves(scene_det), tangents))
        dt = fwad.unpack_dual(_shadow_terms(sc, table, s, keep)).tangent
    if dt is not None:
        out[keep] = dt
    return out


def _shadow_setup(scene_det, edges: EdgeTable):
    """What every pass of one backward shares: the queries' context, the
    edges' geometry and the light's faces."""
    verts, faces = scene_det.geometry()[:2]
    return (scene_det.trace_ctx(), _edge_geometry(scene_det, edges),
            light_faces(scene_det, verts, faces))


def _indirect_pass(scene, edges: EdgeTable, grad_image, seed, n_samples,
                   eps_frac=0.01, oc=None, collect=False, indirect_depth=1,
                   points=None, diag_tangent=None, params=None):
    """One shadow pass and its S backward, as the JAX package's
    ``_indirect_pass`` returns them: (grads, None, None); with
    ``diag_tangent`` ({path: tangent}) (grads, cube points, each lane's
    directional derivative (N, 1 + depths)); with ``collect`` (grads,
    cube points, |mass|)."""
    if params is None:
        params = float_leaves(scene)
    scene_det = _detached(scene)
    with torch.no_grad():
        ctx, geo, lights = _shadow_setup(scene_det, edges)
        s = _shadow_pass(scene_det, ctx, geo, lights, grad_image, seed,
                         n_samples, eps_frac, indirect_depth, oc=oc,
                         points=points)
    grads = _shadow_backward(scene_det, edges, s, params)
    if diag_tangent is not None:
        return grads, s.points, _shadow_tangents(scene_det, edges, s,
                                                 diag_tangent)
    if collect:
        return grads, s.points, s.mass()
    return grads, None, None


def indirect_boundary_grads(scene, edges: EdgeTable, grad_image, seed,
                            n_samples: int = 4096, eps_frac: float = 0.01,
                            guiding: str = "uniform",
                            n_warmup: int | None = None,
                            indirect_depth: int = 1, params=None):
    """Shadow (indirect-visibility) boundary gradients {path: gradient} of
    sum(grad_image * image) for the float leaves ``params`` (default all
    of the scene's), for direct illumination by the scene's one constant
    area light and, with ``indirect_depth`` k > 1, its shadows seen
    through up to k - 1 more bounces (projective.py:384-790).

    A light point y and an edge point x_e, the edge a silhouette as seen
    from y, define the ray whose continuation hits the receiver at the
    shadow's boundary x_B.  The boundary term of the direct-lighting
    integral is

        sum  A_L / (p_edge N) x Delta[W f G Le](x_B) x |dx_B / dl_e|
             x (n_r . dx_B / dtheta)

    with x_B attached through the edge, the light and the receiver's
    plane, W the ptracer-style camera connection (the sensor's weight
    times the adjoint BSDF at the receiver) and Delta from visibility
    rays either side of the curve.  ``guiding="octree"`` first runs a
    warm-up pass of ``n_warmup`` (default max(n_samples // 4, 512))
    uniform cube points and samples the main pass from the octree built
    from their |contribution| (guiding.py:141); ``"projective"`` starts
    the warm-up at ``project_seed_points``' silhouettes, a failed seed
    replaced by a uniform cube point.  Any other mode samples uniformly.
    The octree's build reads the warm-up back to the host once."""
    if params is None:
        params = float_leaves(scene)
    scene_det = _detached(scene)
    seed = int(seed) & rng.MASK32
    with torch.no_grad():
        ctx, geo, lights = _shadow_setup(scene_det, edges)
        oc = None
        if guiding in ("octree", "projective"):
            n_w = n_warmup or max(n_samples // 4, 512)
            seed_points = None
            if guiding == "projective":
                pts, ok = project_seed_points(
                    scene_det, edges, build_face_adjacency(scene_det, edges),
                    seed ^ _PROJECTION_SALT, n_w)
                lane_w = torch.arange(n_w, dtype=torch.int64,
                                      device=pts.device)
                seed_f = seed ^ _FALLBACK_SALT
                fallback = torch.stack([
                    rng.sample_1d(seed_f, lane_w, dim)
                    for dim in (DIM_B_EDGE, DIM_B_T, DIM_B_SUB)], dim=-1)
                seed_points = torch.where(ok[:, None], pts, fallback)
            pts, mass = _shadow_pass(
                scene_det, ctx, geo, lights, grad_image, seed ^ _WARMUP_SALT,
                n_w, eps_frac, indirect_depth, points=seed_points,
                collect=True)
            oc = OcSpaceDistr.create_from_samples(pts, mass)
        s = _shadow_pass(scene_det, ctx, geo, lights, grad_image, seed,
                         n_samples, eps_frac, indirect_depth, oc=oc)
    return _shadow_backward(scene_det, edges, s, params)


# ---------------------------------------------------------- integrators

@dataclass
class PathProjectiveIntegrator:
    """prb_projective: PRB's continuous gradients plus the primary
    silhouette boundary term (prb_projective.py:8) and, with ``indirect``
    on a scene lit by one constant area light, the shadow-boundary term
    at ``sppi`` samples, its shadows seen through up to
    ``indirect_depth`` - 1 bounces; ``guiding`` "octree" or
    "projective" guides the shadow term too, any other mode leaves it
    uniform.  ``sppc`` is kept for the JAX package's settings, whose
    estimator also reads the render's spp."""

    max_depth: int = 6
    rr_depth: int = 5
    sppc: int = 0
    sppp: int = 4096        # boundary samples
    n_sub: int = 4
    guiding: str = "grid"
    indirect: bool = True
    sppi: int = 16384
    indirect_depth: int = 1

    id = "prb_projective"

    def sample(self, scene, ray, lane, seed, active):
        return PathIntegrator(max_depth=self.max_depth,
                              rr_depth=self.rr_depth).sample(
            scene, ray, lane, seed, active)

    def _prb(self):
        return PRBIntegrator(max_depth=self.max_depth, rr_depth=self.rr_depth)


@dataclass
class DirectProjectiveIntegrator:
    """direct_projective: the single-bounce variant
    (direct_projective.py); its shadow term sees x_B from the camera
    alone (indirect_depth 1)."""

    sppp: int = 4096
    n_sub: int = 4
    guiding: str = "grid"
    indirect: bool = True
    sppi: int = 16384

    id = "direct_projective"
    max_depth = 2
    rr_depth = 64

    def sample(self, scene, ray, lane, seed, active):
        return PathIntegrator(max_depth=2, rr_depth=64).sample(
            scene, ray, lane, seed, active)

    def _prb(self):
        return PRBIntegrator(max_depth=2, rr_depth=64)


# ---------------------------------------------------------------- render

def _shadow_term_applies(scene, integrator):
    """Where the JAX package adds the shadow-boundary term
    (projective.py:914-930): ``indirect`` on a scene whose only emitter is
    an area light of constant radiance, on a mesh.  An analytic sphere
    light is left out, logged: the shadow pass samples light points on
    mesh faces only (JAX's set of them is empty there, and it raises)."""
    if not (integrator.indirect and len(scene.emitters) == 1):
        return False
    e = scene.emitters[0]
    if not (isinstance(e, AreaEmitter)
            and isinstance(e.radiance, ConstantTexture)):
        return False
    if scene.emitter_shape[0] >= scene._analytic_base():
        _log.info("prb_projective: the shadow-boundary term is left out: "
                  "the area light is an analytic sphere, and the shadow "
                  "pass samples light points on mesh faces only")
        return False
    return True


class _ProjectiveRender(torch.autograd.Function):
    """The primal render forward; PRB's adjoint plus the primary boundary
    term and, where it applies, the shadow-boundary term backward."""

    @staticmethod
    def forward(ctx, scene, edges, integrator, seed, spp, keys, *values):
        ctx.save_for_backward(*values)
        ctx.args = (_detached(scene), edges, integrator, seed, spp, keys)
        return _primal_image(ctx.args[0], integrator, seed, spp)

    @staticmethod
    def backward(ctx, grad_image):
        scene_det, edges, integrator, seed, spp, keys = ctx.args
        leaves = dict(zip(keys, ctx.saved_tensors))
        grads = _adjoint(scene_det, integrator._prb(), seed, spp, grad_image,
                         leaves)
        bnd = primary_boundary_grads(
            scene_det, edges, PathIntegrator(max_depth=integrator.max_depth,
                                             rr_depth=integrator.rr_depth),
            grad_image, seed, n_samples=integrator.sppp,
            n_sub=integrator.n_sub, guiding=integrator.guiding, params=leaves)
        total = {k: grads[k] + bnd[k] for k in keys}
        if scene_det.scene_analytic is not None and \
                getattr(scene_det.sensor, "to_world", None) is not None:
            abnd = analytic_boundary_grads(
                scene_det, PathIntegrator(max_depth=integrator.max_depth,
                                          rr_depth=integrator.rr_depth),
                grad_image, seed, n_samples=max(integrator.sppp // 2, 512),
                n_sub=integrator.n_sub, params=leaves)
            total = {k: total[k] + abnd[k] for k in keys}
        if _shadow_term_applies(scene_det, integrator):
            guiding = integrator.guiding
            ind = indirect_boundary_grads(
                scene_det, edges, grad_image, seed,
                n_samples=integrator.sppi,
                guiding=(guiding if guiding in ("octree", "projective")
                         else "uniform"),
                indirect_depth=getattr(integrator, "indirect_depth", 1),
                params=leaves)
            total = {k: total[k] + ind[k] for k in keys}
        return (None,) * 6 + tuple(total[k] for k in keys)


def _log_shapes_without_boundary(scene):
    """Curves, SDF grids and instanced groups get no boundary term, as in
    the JAX package (its analytic silhouettes are spheres and disks only,
    projective.py:264): logged once a render."""
    an = scene.scene_analytic
    kinds = [k for k, has in (
        ("curve prims", an is not None and an.n_curves > 0),
        ("an SDF grid", scene.scene_sdf is not None),
        ("instanced groups", bool(scene.instances))) if has]
    if kinds:
        _log.info("prb_projective: no boundary term for the scene's %s: their "
                  "silhouettes and shadows are left out, as in the JAX "
                  "package", ", ".join(kinds))


def prb_projective_render(scene, edges, integrator, seed=0, spp: int = 16,
                          device=None):
    """Differentiable render whose gradient includes the visibility
    boundaries (``mi.render`` with a projective integrator): the (H, W, 3)
    image, at ``spp``, whose gradients for every float leaf of ``scene``
    that requires grad are PRB's (``prb._adjoint``: the depth-0 rays
    regenerated attached and the sensor's importance-weight term, so a
    camera pose gets its continuous part) plus ``primary_boundary_grads``
    at ``integrator.sppp`` samples, plus, on a scene with analytic prims,
    ``analytic_boundary_grads`` at max(sppp // 2, 512) samples, plus
    ``indirect_boundary_grads`` at ``integrator.sppi`` where the JAX package adds it (``indirect`` on a
    scene lit by one constant area light).  (The JAX package's
    ``_ppr_bwd`` drops the continuous sensor part; ROADMAP.md Queue 3
    lists it among the reference's faults.)

    ``edges``: ``build_silhouette_edges(scene)``, built once (the
    topology is static).  Runs on ``device`` (default: the GPU, raising
    without one; pass ``device="cpu"`` for the CPU), which must be the
    scene's."""
    check_device(scene, device)
    inputs = {k: v for k, v in float_leaves(scene).items() if v.requires_grad}
    if not inputs or not torch.is_grad_enabled():
        with torch.no_grad():
            return _primal_image(_detached(scene), integrator, seed, spp)
    _log_shapes_without_boundary(scene)
    return _ProjectiveRender.apply(scene, edges, integrator, seed, spp,
                                   tuple(inputs), *inputs.values())
