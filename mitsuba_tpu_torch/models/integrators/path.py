"""Wavefront path tracer: NEE + MIS (power heuristic) + russian roulette
(mitsuba_tpu/models/integrators/path.py; reference
src/integrators/path.cpp:95-300).

Every depth intersects the whole wavefront, adds the MIS'd radiance of
the environment map along escaped rays and of emitters hit, does NEE
with a shadow ray, samples the BSDF and advances the rays.  The JAX
``lax.while_loop`` becomes a Python loop over depths that keeps JAX's
masked lanes: every tensor stays (N, ...), the ray
queries skip inactive lanes, and the loop stops once no lane is active
(one host check a depth).  The random numbers are the same (seed, lane,
dim) stream, so per-lane radiance matches the JAX integrator to float
rounding and hit ties.

The hit queries are the scene's (models/scene.py): ``intersect_packed``
without a BVH, ``packet_closest_hit``/``packet_any_hit`` with one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import rng
from .common import (SLOT_BSDF_DIR, SLOT_BSDF_LOBE, SLOT_EM_POS,
                     SLOT_EM_SELECT, SLOT_RR, bounce_dim, mis_weight,
                     sampler_spec)


@dataclass
class PathIntegrator:
    max_depth: int = 6
    rr_depth: int = 5
    hide_emitters: bool = False
    # not ported: attached ray differentials and the render timeout
    ray_diffs: bool = False
    timeout: float = 0.0

    def __post_init__(self):
        if self.ray_diffs or self.timeout:
            raise NotImplementedError(
                "PathIntegrator ray_diffs and timeout are not ported "
                "(ROADMAP.md, Queue 1, items 6 and 8)")

    def sample(self, scene, ray, lane, seed, active):
        """Per-lane radiance estimate L (N, 3)."""
        n = ray.o.shape[0]
        dev = ray.o.device
        sampler_spec(scene)
        ctx = scene.trace_ctx()
        lane = rng.as_u32(lane)

        def u1(depth, slot):
            return rng.sample_1d(seed, lane, bounce_dim(depth, slot))

        def u2(depth, slot):
            return rng.sample_2d(seed, lane, bounce_dim(depth, slot))

        L = torch.zeros((n, 3), device=dev)
        beta = torch.ones((n, 3), device=dev)
        eta = torch.ones(n, device=dev)
        act = active
        prev_p = ray.o
        prev_pdf = torch.ones(n, device=dev)
        prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
        for depth in range(self.max_depth):
            if not bool(act.any()):
                break
            si = scene.ray_intersect(ray, act, ctx)

            # ---- the environment's radiance along escaped rays, with MIS
            if scene.env_index >= 0 and not self.hide_emitters:
                escaped = act & ~si.is_valid()
                le_env, pdf_env = scene.eval_env(ray, prev_p, escaped)
                mis_e = torch.where(prev_delta, 1.0,
                                    mis_weight(prev_pdf, pdf_env))
                L = L + beta * le_env * torch.where(escaped, mis_e,
                                                    0.0)[:, None]
            act = act & si.is_valid()

            # ---- radiance of emitters hit, with MIS
            if not self.hide_emitters:
                le, pdf_em = scene.eval_emitter_hit(si, prev_p, act)
                mis_h = torch.where(prev_delta, 1.0,
                                    mis_weight(prev_pdf, pdf_em))
                L = L + beta * le * torch.where(act, mis_h, 0.0)[:, None]

            act_next = act & (depth + 1 < self.max_depth)

            # ---- next-event estimation (path.cpp:195-230)
            if scene.emitters:
                ds, em_weight, ok = scene.sample_emitter_direction(
                    si, u1(depth, SLOT_EM_SELECT), u2(depth, SLOT_EM_POS),
                    act_next, ctx)
                bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d),
                                                         ok)
                mis_em = torch.where(ds.delta, 1.0,
                                     mis_weight(ds.pdf, bsdf_pdf))
                L = L + beta * bsdf_val * em_weight * torch.where(
                    ok, mis_em, 0.0)[:, None]

            # ---- BSDF sampling (path.cpp:216)
            bs, bsdf_w = scene.bsdf_sample(si, u1(depth, SLOT_BSDF_LOBE),
                                           u2(depth, SLOT_BSDF_DIR), act_next)
            ray = si.spawn_ray(si.to_world(bs.wo))
            beta = beta * bsdf_w
            eta = eta * torch.where(act_next, bs.eta, 1.0)
            act_next = act_next & (bs.pdf > 0.0) & (beta > 0.0).any(dim=-1)

            # ---- russian roulette (path.cpp:254-263)
            if depth + 1 >= self.rr_depth:
                rr_prob = torch.clamp(beta.amax(dim=-1) * eta * eta, max=0.95)
                beta = torch.where(act_next[:, None],
                                   beta / torch.clamp(rr_prob, min=1e-8)[:, None],
                                   beta)
                act_next = act_next & (u1(depth, SLOT_RR) < rr_prob)

            prev_p = si.p
            prev_pdf = torch.where(act_next, bs.pdf, prev_pdf)
            prev_delta = torch.where(act_next, bs.delta, prev_delta)
            act = act_next
        return L
