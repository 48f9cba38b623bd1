"""Projective (visibility-discontinuity) gradients: the primary
silhouette boundary term (mitsuba_tpu/models/integrators/projective.py;
reference src/python/python/ad/projective.py, integrators/
prb_projective.py and direct_projective.py).

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
(``guiding.py``).  The shadow (indirect-visibility) term with its
octree guiding and the hybrid projection (``indirect_boundary_grads``,
``_indirect_pass``, ``OcSpaceDistr``, ``projection.py``) wait for
ROADMAP.md Queue 1 item 5b: a projective integrator with
``indirect=True`` raises on a scene where the JAX package would add that
term.  The port's scenes hold meshes only, so the JAX package's
``analytic_boundary_grads`` never applies.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.autograd.forward_ad as fwad

from ...core import rng
from ...core.math import cross, dot
from ...core.records import Ray
from ...utils.params import float_leaves, update
from ..emitters import AreaEmitter
from ..textures import ConstantTexture
from .common import DIM_APERTURE, DIM_WAVELENGTH, check_device
from .guiding import GridDistr, UniformDistr
from .path import PathIntegrator
from .prb import PRBIntegrator, _adjoint, _detached, _primal_image

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
    return n / torch.sqrt(torch.clamp(dot(n, n, keepdim=True), min=1e-20))


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
    dist = torch.sqrt(torch.clamp(dot(d, d), min=1e-20))
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
    speed = torch.sqrt(torch.clamp(dot(du_dl, du_dl), min=1e-20))
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
        verts, faces = scene_det.geometry()[:2]
        p0, p1 = verts[edges.v0], verts[edges.v1]
        lengths = torch.sqrt(torch.clamp(dot(p1 - p0, p1 - p0), min=1e-20))
        geo = _Edges(edges, p0, p1, lengths, _face_normals(verts, faces))

        def one_pass(distr, pass_salt):
            return _boundary_pass(scene_det, ctx, geo, integrator, grad_image,
                                  seed_b, distr, n_samples, n_sub, eps_px,
                                  pass_salt)

        if guiding != "uniform":
            warm = GridDistr.create(lengths)
            idx_w, _, _, coeff_w, _ = one_pass(warm, 1)
            distr = warm.update(idx_w, torch.abs(coeff_w)).finalize()
        else:
            distr = UniformDistr.create(lengths)
        idx, t, m_hat, coeff, _ = one_pass(distr, 0)
    return _boundary_backward(scene_det, edges, idx, t,
                              coeff[:, None] * m_hat, params)


# ---------------------------------------------------------- integrators

@dataclass
class PathProjectiveIntegrator:
    """prb_projective: PRB's continuous gradients plus the primary
    silhouette boundary term (prb_projective.py:8).  ``indirect``,
    ``sppi`` and ``indirect_depth`` set the shadow term, which is not
    ported (ROADMAP.md Queue 1 item 5b); ``sppc`` is kept for the JAX
    package's settings, whose estimator also reads the render's spp."""

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
    (direct_projective.py)."""

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

def _check_shadow_term(scene, integrator):
    """Raises where the JAX package would add the shadow-boundary term
    (projective.py:914-930): ``indirect`` on a scene whose only emitter
    is an area light of constant radiance."""
    if integrator.indirect and len(scene.emitters) == 1:
        e = scene.emitters[0]
        if isinstance(e, AreaEmitter) and isinstance(e.radiance,
                                                     ConstantTexture):
            raise NotImplementedError(
                "the shadow-boundary term (indirect=True on a scene lit by "
                "one constant area light) is not ported: ROADMAP.md Queue 1 "
                "item 5b; pass indirect=False for the primary term alone")


class _ProjectiveRender(torch.autograd.Function):
    """The primal render forward; PRB's adjoint plus the primary boundary
    term backward."""

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
        return (None,) * 6 + tuple(grads[k] + bnd[k] for k in keys)


def prb_projective_render(scene, edges, integrator, seed=0, spp: int = 16,
                          device=None):
    """Differentiable render whose gradient includes the primarily
    visible silhouettes (``mi.render`` with a projective integrator): the
    (H, W, 3) image, at ``spp``, whose gradients for every float leaf of
    ``scene`` that requires grad are PRB's (``prb._adjoint``: the depth-0
    rays regenerated attached and the sensor's importance-weight term,
    so a camera pose gets its continuous part) plus
    ``primary_boundary_grads`` at ``integrator.sppp`` samples.  (The JAX
    package's ``_ppr_bwd`` drops that continuous sensor part; ROADMAP.md
    Queue 3 lists it among the reference's faults.)

    ``edges``: ``build_silhouette_edges(scene)``, built once (the
    topology is static).  Runs on ``device`` (default: the GPU, raising
    without one; pass ``device="cpu"`` for the CPU), which must be the
    scene's.  Raises ``NotImplementedError`` where the shadow term would
    apply (``indirect=True``, one constant area light)."""
    check_device(scene, device)
    _check_shadow_term(scene, integrator)
    inputs = {k: v for k, v in float_leaves(scene).items() if v.requires_grad}
    if not inputs or not torch.is_grad_enabled():
        with torch.no_grad():
            return _primal_image(_detached(scene), integrator, seed, spp)
    return _ProjectiveRender.apply(scene, edges, integrator, seed, spp,
                                   tuple(inputs), *inputs.values())
