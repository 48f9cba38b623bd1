"""Basic PRB (no NEE, no russian roulette) and the fork's deterministic
lens tracer (mitsuba_tpu/models/integrators/prb_basic.py; reference
src/python/python/ad/integrators/prb_basic.py).

``trace`` propagates rays through refractive interfaces by forcing the
transmission lobe (sample1 = 1 never picks the reflection lobe) at every
hit and returns the penultimate ray and the final hit point, attached to
the lens meshes' vertices through ``compute_si`` (the lens-design
geometric tracer, design_problem.py:416 of the reference).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import rng
from .common import SLOT_BSDF_DIR, SLOT_BSDF_LOBE, bounce_dim


@dataclass
class PRBBasicIntegrator:
    max_depth: int = 6
    hide_emitters: bool = False

    def sample(self, scene, ray, lane, seed, active):
        """Primal estimator: BSDF-sampling-only path tracing (prb_basic.py
        sample, primal mode).  Per-lane radiance L (N, 3)."""
        n = ray.o.shape[0]
        dev = ray.o.device
        ctx = scene.trace_ctx()
        lane = rng.as_u32(lane)
        L = torch.zeros((n, 3), device=dev)
        beta = torch.ones((n, 3), device=dev)
        act = active
        prev_p = ray.o
        for depth in range(self.max_depth):
            if not bool(act.any()):
                break
            si = scene.ray_intersect(ray, act, ctx)
            escaped = act & ~si.is_valid()
            if scene.env_index >= 0 and not self.hide_emitters:
                le_env, _ = scene.eval_env(ray, prev_p, escaped)
                L = L + beta * torch.where(escaped, 1.0, 0.0)[:, None] * le_env
            act = act & si.is_valid()
            if not self.hide_emitters:
                le, _ = scene.eval_emitter_hit(si, prev_p, act)
                L = L + beta * le
            act_next = act & (depth + 1 < self.max_depth)
            bs, bw = scene.bsdf_sample(
                si, rng.sample_1d(seed, lane, bounce_dim(depth,
                                                         SLOT_BSDF_LOBE)),
                rng.sample_2d(seed, lane, bounce_dim(depth, SLOT_BSDF_DIR)),
                act_next)
            beta = beta * bw
            act = act_next & (bs.pdf > 0.0) & (beta > 0.0).any(dim=-1)
            ray = si.spawn_ray(si.to_world(bs.wo))
            prev_p = si.p
        return L

    def trace(self, scene, ray, num_lenses: int):
        """Forced-transmission propagation through ``num_lenses`` surface
        hits (prb_basic.py:46).  Returns (penultimate_o, penultimate_d,
        valid, p_final): ``valid`` marks lanes whose final vertex lies on
        the film plane z = 0, ``p_final`` is the final hit position."""
        n = ray.o.shape[0]
        dev = ray.o.device
        ctx = scene.trace_ctx()
        pen_o, pen_d = ray.o, ray.d
        p = torch.zeros((n, 3), device=dev)
        z = torch.full((n,), float("inf"), device=dev)
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        act = torch.ones(n, dtype=torch.bool, device=dev)
        one = torch.ones(n, device=dev)
        zero2 = torch.zeros((n, 2), device=dev)
        for _ in range(num_lenses):
            if not bool(act.any()):
                break
            si = scene.ray_intersect(ray, act, ctx)
            valid = si.is_valid()
            act_next = act & valid
            bs, bw = scene.bsdf_sample(si, one, zero2, act_next)
            pen_o = torch.where(act_next[:, None], ray.o, pen_o)
            pen_d = torch.where(act_next[:, None], ray.d, pen_d)
            ray = si.spawn_ray(si.to_world(bs.wo))
            p = torch.where(act_next[:, None], si.p, p)
            z = torch.where(act_next, si.p[..., 2], z)
            hit = torch.where(act, valid, hit)
            act = act_next & (bw > 0.0).any(dim=-1)
        return pen_o, pen_d, hit & (torch.abs(z) < 1e-5), p
