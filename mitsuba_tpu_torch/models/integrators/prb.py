"""Path-replay backpropagation (PRB), the differentiable-rendering core
(mitsuba_tpu/models/integrators/prb.py; reference
src/python/python/ad/integrators/common.py:492-796 and prb.py:59-257).

How the JAX package's mechanisms map here:

- ``jax.custom_vjp`` around the primal render -> ``prb_render``, a
  ``torch.autograd.Function`` whose inputs are the scene's leaves that
  require grad;
- the per-lane adjoint ``delta_L`` -> ``torch.autograd.grad`` through
  splat and develop;
- the sampler replay -> the stateless (seed, lane, dim) RNG, which
  re-derives the primal walk's samples exactly;
- the attached re-evaluation inside a local ``jax.grad`` -> at each
  depth, the scene rebuilt around fresh leaves (``utils/params.update``)
  under ``torch.enable_grad()``, then ``torch.autograd.grad`` of that
  depth's contribution, accumulated over depths: one depth's graph at a
  time, so memory stays O(1) in depth;
- ``jax.jvp`` of the same re-evaluation -> ``torch.autograd.forward_ad``
  dual tensors (``sample_forward``, ``prb_render_forward``).

The detached walk is the wavefront ``PathIntegrator``'s, on a scene
whose leaves are detached: its hit queries (``intersect_packed`` or the
BVH kernels) see detached rays and tables only.  Only ``compute_si``,
the BSDF, texture and emitter evaluation and ``_nee_geometry_attached``
are attached.  Like the reference's ``prb``, the estimator ignores
visibility discontinuities.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.autograd.forward_ad as fwad

from ...core import rng
from ...core.math import dot, sqrt
from ...core.records import (BSDFSample, DirectionSample,
                             PreliminaryIntersection, Ray)
from ...utils.params import float_leaves, update
from .common import (SLOT_BSDF_DIR, SLOT_BSDF_LOBE, SLOT_EM_POS,
                     SLOT_EM_SELECT, SLOT_RR, _render_pass, bounce_dim,
                     check_device, mis_weight, sample_rays, sampler_spec)
from .path import PathIntegrator


def _nee_geometry_attached(si, ds, active):
    """Attached NEE geometry for the adjoint re-evaluation (prb.py:52-80).

    The emitter point ``ds.p`` stays detached (it is the integration
    variable), but the direction, the 1/r^2 falloff and the emitter-side
    cosine are functions of the attached shading point ``si.p``: the
    geometric ratio ``jac`` (primal value exactly 1) carries them, so
    receiver-motion gradients are complete.  Samples at infinity keep
    jac = 1, and so do the lanes off ``active`` (lanes whose NEE term is
    0, a self-lit one among them), with the detached direction: no
    gradient through a degenerate chord.  Returns (d_att, jac)."""
    d_vec = ds.p - si.p
    r2 = torch.clamp(dot(d_vec, d_vec), min=1e-20)
    d_att = d_vec / sqrt(r2)[:, None]
    finite = (ds.dist < 1e7) & active
    has_n = dot(ds.n, ds.n) > 0.5
    cos_att = torch.where(has_n, torch.abs(dot(d_att, ds.n)),
                          1.0)
    g_att = cos_att / r2
    g_det = g_att.detach()
    good = finite & (g_det > 1e-12)
    # the double where: an unselected lane's 0 / 0 gives no NaN gradient
    jac = torch.where(good, torch.where(good, g_att, 1.0)
                      / torch.where(good, g_det, 1.0), 1.0)
    return torch.where(finite[:, None], d_att, ds.d), jac


@dataclass
class Bounce:
    """One depth of the detached walk: what the attached re-evaluation of
    that depth reads (prb.py:178-210)."""

    depth: int
    ray: Ray
    pi: PreliminaryIntersection
    beta: torch.Tensor        # (N, 3) throughput before this depth
    prev_p: torch.Tensor      # (N, 3) the previous vertex
    act_hit: torch.Tensor     # (N,) active lanes that hit
    escaped: torch.Tensor     # (N,) active lanes that missed
    act_next: torch.Tensor    # (N,) lanes that sample a next direction
    mis_hit: torch.Tensor     # (N,) MIS weight of an emitter hit
    mis_env: torch.Tensor     # (N,) MIS weight of the environment
    bs: BSDFSample
    ds: DirectionSample | None = None   # the NEE sample, if any emitter
    ok: torch.Tensor | None = None      # (N,) the NEE sample is unoccluded
    mis_em: torch.Tensor | None = None  # (N,) its MIS weight
    inv_ds_pdf: torch.Tensor | None = None


@dataclass
class PRBIntegrator:
    """prb: PRB with NEE and MIS (registered as "prb", prb.py:259)."""

    max_depth: int = 6
    rr_depth: int = 5

    def sample(self, scene, ray, lane, seed, active):
        """Primal estimator: the walk of ``PathIntegrator`` (the replay
        needs the same RNG dimension layout)."""
        return PathIntegrator(max_depth=self.max_depth,
                              rr_depth=self.rr_depth).sample(
            scene, ray, lane, seed, active)

    # ---------------------------------------------------------- the replay

    def replay(self, scene, ray, lane, seed, active):
        """The walk of (seed, lane) on ``scene`` (whose leaves must be
        detached), as ``PathIntegrator.sample`` takes it: yields each
        depth's ``Bounce`` before advancing to the next."""
        n = ray.o.shape[0]
        dev = ray.o.device
        sampler_spec(scene)
        ctx = scene.trace_ctx()
        lane = rng.as_u32(lane)

        def u1(depth, slot):
            return rng.sample_1d(seed, lane, bounce_dim(depth, slot))

        def u2(depth, slot):
            return rng.sample_2d(seed, lane, bounce_dim(depth, slot))

        beta = torch.ones((n, 3), device=dev)
        eta = torch.ones(n, device=dev)
        act = active
        prev_p = ray.o
        prev_pdf = torch.ones(n, device=dev)
        prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
        for depth in range(self.max_depth):
            if not bool(act.any()):
                break
            pi = scene.ray_intersect_preliminary(ray, act, ctx)
            si = scene.compute_si(pi, ray, ctx)
            valid = si.is_valid()
            escaped = act & ~valid
            act_hit = act & valid
            _, pdf_hit = scene.eval_emitter_hit(si, prev_p, act_hit)
            _, pdf_env = scene.eval_env(ray, prev_p, escaped)
            mis_hit = torch.where(prev_delta, 1.0,
                                  mis_weight(prev_pdf, pdf_hit))
            mis_env = torch.where(prev_delta, 1.0,
                                  mis_weight(prev_pdf, pdf_env))
            act_next = act_hit & (depth + 1 < self.max_depth)
            nee = {}
            if scene.emitters:
                ds, _, ok = scene.sample_emitter_direction(
                    si, u1(depth, SLOT_EM_SELECT), u2(depth, SLOT_EM_POS),
                    act_next, ctx)
                _, bsdf_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d), ok)
                mis_em = torch.where(ds.delta, 1.0,
                                     mis_weight(ds.pdf, bsdf_pdf))
                pos = ds.pdf > 0.0
                nee = dict(ds=ds, ok=ok,
                           mis_em=torch.where(ok, mis_em, 0.0),
                           inv_ds_pdf=torch.where(
                               pos, 1.0 / torch.where(pos, ds.pdf, 1.0), 0.0))
            bs, bsdf_w = scene.bsdf_sample(si, u1(depth, SLOT_BSDF_LOBE),
                                           u2(depth, SLOT_BSDF_DIR), act_next)
            yield Bounce(depth=depth, ray=ray, pi=pi, beta=beta, prev_p=prev_p,
                         act_hit=act_hit, escaped=escaped, act_next=act_next,
                         mis_hit=torch.where(act_hit, mis_hit, 0.0),
                         mis_env=torch.where(escaped, mis_env, 0.0), bs=bs,
                         **nee)

            # advance the detached walk (path.py)
            ray = si.spawn_ray(si.to_world(bs.wo))
            beta = beta * bsdf_w
            eta = eta * torch.where(act_next, bs.eta, 1.0)
            act_next = act_next & (bs.pdf > 0.0) & (beta > 0.0).any(dim=-1)
            if depth + 1 >= self.rr_depth:
                rr_prob = torch.clamp(beta.amax(dim=-1) * eta * eta, max=0.95)
                beta = torch.where(act_next[:, None],
                                   beta / torch.clamp(rr_prob,
                                                      min=1e-8)[:, None],
                                   beta)
                act_next = act_next & (u1(depth, SLOT_RR) < rr_prob)
            prev_p = si.p
            prev_pdf = torch.where(act_next, bs.pdf, prev_pdf)
            prev_delta = torch.where(act_next, bs.delta, prev_delta)
            act = act_next

    @staticmethod
    def reevaluate(sc, b: Bounce, L, ray):
        """The attached re-evaluation of one depth (prb.py:213-250) on the
        scene ``sc``: (what the depth adds to the radiance, Le + Lr_dir +
        Lr_ind, and ``L`` peeled of this depth's emission and NEE).  Only
        the ratio bsdf / detached(bsdf) of the indirect term carries a
        gradient (the reference's replace_grad)."""
        si = sc.compute_si(b.pi, ray)
        le_hit, _ = sc.eval_emitter_hit(si, b.prev_p, b.act_hit)
        le_env, _ = sc.eval_env(ray, b.prev_p, b.escaped)
        le = b.beta * (b.mis_hit[:, None] * le_hit
                       + b.mis_env[:, None] * le_env)
        lr_dir = torch.zeros_like(le)
        if b.ds is not None:
            em_val = sc.eval_emitter_direction(si, b.ds, b.ok)
            d_att, jac = _nee_geometry_attached(si, b.ds, b.ok)
            bsdf_nee, _ = sc.bsdf_eval_pdf(si, si.to_local(d_att), b.ok)
            lr_dir = (b.beta * (b.mis_em * b.inv_ds_pdf * jac)[:, None]
                      * bsdf_nee * em_val)
        peeled = L - le.detach() - lr_dir.detach()
        bsdf_ind, _ = sc.bsdf_eval_pdf(si, b.bs.wo, b.act_next)
        det = bsdf_ind.detach()
        pos = det > 0.0
        ratio = bsdf_ind * torch.where(
            pos, 1.0 / torch.where(pos, det, 1.0), 0.0)
        return le + lr_dir + peeled * ratio, peeled

    # ----------------------------------------------------------- adjoint

    def sample_backward(self, scene, ray, lane, seed, delta_L, L0, active,
                        ray_fn=None, params=None):
        """Replay the walk of (seed, lane), propagating the per-lane
        adjoint ``delta_L`` (N, 3) into gradients (prb.py:128-287).

        ``params``: {path: tensor} of the scene's float leaves to
        differentiate (default: all of them); returns {path: gradient}.
        ``ray_fn(attached_scene) -> Ray`` regenerates the primary rays
        from the attached scene, so sensor parameters receive gradients
        through the depth-0 interaction (common.py:302).  Each depth's
        graph is built, differentiated and freed before the next."""
        if params is None:
            params = float_leaves(scene)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        xs = list(leaves.values())
        scene_det = _detached(scene)
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        L = L0
        with torch.no_grad():
            for b in self.replay(scene_det, ray, lane, seed, active):
                with torch.enable_grad():
                    sc = update(scene_det, leaves)
                    ray_c = (ray_fn(sc) if ray_fn is not None and b.depth == 0
                             else b.ray)
                    lo, peeled = self.reevaluate(sc, b, L, ray_c)
                    contrib = torch.sum(delta_L * lo)
                    g = (torch.autograd.grad(contrib, xs, allow_unused=True)
                         if contrib.requires_grad else [None] * len(xs))
                for k, gk in zip(leaves, g):
                    if gk is not None:
                        grads[k] += gk
                L = peeled.detach()
        return grads

    def sample_forward(self, scene, tangents, ray, lane, seed, L0, active,
                       ray_fn=None):
        """Forward-mode replay (prb.py:289-420): the per-lane radiance
        tangent dL (N, 3) along ``tangents`` ({path: tangent} of float
        leaves), one depth's dual tensors at a time."""
        floats = float_leaves(scene)
        scene_det = _detached(scene)
        dL = torch.zeros_like(L0)
        L = L0
        with torch.no_grad():
            for b in self.replay(scene_det, ray, lane, seed, active):
                with fwad.dual_level():
                    sc = update(scene_det, _duals(floats, tangents))
                    ray_c = (ray_fn(sc) if ray_fn is not None and b.depth == 0
                             else b.ray)
                    lo, peeled = self.reevaluate(sc, b, L, ray_c)
                    t = fwad.unpack_dual(lo).tangent
                    L = fwad.unpack_dual(peeled).primal
                if t is not None:
                    dL = dL + t
        return dL


# ------------------------------------------------------------ render()

def _detached(scene):
    """``scene`` with every float leaf detached."""
    return update(scene, {k: v.detach()
                          for k, v in float_leaves(scene).items()})


def _duals(floats, tangents):
    """{path: dual tensor} of the leaves ``floats`` along ``tangents``,
    inside a ``forward_ad.dual_level``."""
    return {k: fwad.make_dual(floats[k].detach(),
                              t.to(floats[k].device, floats[k].dtype))
            for k, t in tangents.items()}


def _primal_image(scene, integrator, seed, spp):
    return scene.sensor.film.develop(
        _render_pass(scene, integrator, seed, spp, spp, 0))


def prb_render_forward(scene, tangents, integrator, seed=0,
                       spp: int = 16, device=None):
    """Forward-mode differentiable render (prb.py:423-456, the reference's
    render_forward): (image, d image along ``tangents``).

    ``tangents``: {path: tangent} of float leaves (``utils/params`` paths;
    ``float_leaves`` of a scene of tangents gives the JAX package's
    tangent scene).  Runs on ``device`` (default: the GPU), which must be
    the scene's."""
    check_device(scene, device)
    floats = float_leaves(scene)
    tangents = {k: torch.as_tensor(t) for k, t in tangents.items()
                if k in floats}
    scene_det = _detached(scene)
    film = scene_det.sensor.film
    with torch.no_grad():
        ray, weight, film_pos, lane = sample_rays(scene_det, seed, spp)
        active = torch.ones(ray.o.shape[0], dtype=torch.bool,
                            device=ray.o.device)
        L0 = integrator.sample(scene_det, ray, lane, seed, active)
        dL = integrator.sample_forward(
            scene_det, tangents, ray, lane, seed, L0, active,
            ray_fn=lambda sc: sample_rays(sc, seed, spp)[0])
        # the sensor importance weight's tangent
        with fwad.dual_level():
            sc = update(scene_det, _duals(floats, tangents))
            dweight = fwad.unpack_dual(sample_rays(sc, seed, spp)[1]).tangent
        if dweight is None:
            dweight = torch.zeros_like(weight)
        img = film.develop(film.put_grouped(film_pos, L0 * weight, spp, active))
        dimg = film.develop(film.put_grouped(
            film_pos, dL * weight + L0 * dweight, spp, active))
    return img, dimg


def _adjoint(scene_det, integrator, seed, spp, grad_image, leaves):
    """The backward pass of ``prb_render`` (prb.py:489-537) on the
    detached scene at ``spp`` (the adjoint's sample count): {path:
    gradient} of ``sum(grad_image * image)`` for the leaves ({path:
    tensor}).  Regenerates the adjoint wavefront, takes delta_L from the
    vector-Jacobian product of splat and develop, replays the primal L0,
    runs ``sample_backward`` with the depth-0 rays attached to the sensor
    and adds the sensor importance-weight term."""
    film = scene_det.sensor.film
    with torch.no_grad():
        ray, weight, film_pos, lane = sample_rays(scene_det, seed, spp)
        active = torch.ones(ray.o.shape[0], dtype=torch.bool,
                            device=ray.o.device)
    with torch.enable_grad():
        L = torch.zeros_like(ray.o, requires_grad=True)
        img = film.develop(film.put_grouped(film_pos, L * weight, spp, active))
        (delta_L,) = torch.autograd.grad(img, L, grad_image)
    with torch.no_grad():
        L0 = integrator.sample(scene_det, ray, lane, seed, active)
    grads = integrator.sample_backward(
        scene_det, ray, lane, seed, delta_L, L0, active,
        ray_fn=lambda sc: sample_rays(sc, seed, spp)[0], params=leaves)
    # the sensor importance-weight term: d(splat(weight * L0)) / d(sensor)
    with torch.enable_grad():
        xs = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        w = sample_rays(update(scene_det, xs), seed, spp)[1]
        if w.requires_grad:
            img = film.develop(film.put_grouped(film_pos, w * L0, spp, active))
            g = torch.autograd.grad(torch.sum(grad_image * img),
                                    list(xs.values()), allow_unused=True)
            for k, gk in zip(xs, g):
                if gk is not None:
                    grads[k] += gk
    return grads


class _PRBRender(torch.autograd.Function):
    """The primal render forward, the PRB adjoint backward."""

    @staticmethod
    def forward(ctx, scene, integrator, seed, spp, spp_grad, keys, *values):
        ctx.save_for_backward(*values)
        ctx.args = (_detached(scene), integrator, seed, spp, spp_grad, keys)
        return _primal_image(ctx.args[0], integrator, seed, spp)

    @staticmethod
    def backward(ctx, grad_image):
        scene_det, integrator, seed, spp, spp_grad, keys = ctx.args
        leaves = dict(zip(keys, ctx.saved_tensors))
        grads = _adjoint(scene_det, integrator, seed,
                            spp if spp_grad is None else spp_grad,
                            grad_image, leaves)
        return (None,) * 6 + tuple(grads[k] for k in keys)


def prb_render(scene, integrator, seed=0, spp: int = 16,
               spp_grad: int | None = None, device=None):
    """Differentiable render, the ``mi.render()`` analogue (util.py:410):
    the (H, W, 3) image, whose gradients with respect to every float
    leaf of ``scene`` that requires grad come from the PRB adjoint
    (``_adjoint``), not from autograd through the primal walk.

    ``spp_grad``: the adjoint's sample count (default ``spp``).  Runs on
    ``device`` (default: the GPU, raising without one; pass
    ``device="cpu"`` for the CPU), which must be the scene's.  A leaf
    may be the result of the caller's own operations (``2 * a``): the
    gradient flows on to ``a``."""
    check_device(scene, device)
    inputs = {k: v for k, v in float_leaves(scene).items() if v.requires_grad}
    if not inputs or not torch.is_grad_enabled():
        with torch.no_grad():
            return _primal_image(_detached(scene), integrator, seed, spp)
    return _PRBRender.apply(scene, integrator, seed, spp, spp_grad,
                            tuple(inputs), *inputs.values())
