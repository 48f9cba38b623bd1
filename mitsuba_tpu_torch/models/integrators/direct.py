"""Direct-illumination integrator with emitter and BSDF sampling combined
by MIS (mitsuba_tpu/models/integrators/direct.py; reference
src/integrators/direct.cpp).

One closest hit, then ``emitter_samples`` NEE samples and
``bsdf_samples`` BSDF samples, combined with the power heuristic over
each strategy's share of the samples.  The hit queries are the scene's,
as in ``PathIntegrator``: ``intersect_packed`` without a BVH,
``packet_closest_hit``/``packet_any_hit`` with one.  An escaped ray
carries the environment map's radiance, if the scene has one: a camera
ray unweighted, a BSDF-sampled ray under MIS.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import rng
from .common import (SLOT_BSDF_DIR, SLOT_BSDF_LOBE, SLOT_EM_POS,
                     SLOT_EM_SELECT, bounce_dim, mis_weight, sampler_spec)


@dataclass
class DirectIntegrator:
    emitter_samples: int = 1
    bsdf_samples: int = 1
    hide_emitters: bool = False

    def sample(self, scene, ray, lane, seed, active):
        """Per-lane radiance estimate L (N, 3)."""
        n = ray.o.shape[0]
        sampler_spec(scene)
        frac_em = self.emitter_samples / max(
            self.emitter_samples + self.bsdf_samples, 1)
        frac_bs = 1.0 - frac_em
        weight_em = 1.0 / max(self.emitter_samples, 1)
        weight_bs = 1.0 / max(self.bsdf_samples, 1)
        lane = rng.as_u32(lane)

        L = torch.zeros((n, 3), device=ray.o.device)
        ctx = scene.trace_ctx()
        si = scene.ray_intersect(ray, active, ctx)
        act = active & si.is_valid()
        env = scene.env_index >= 0
        if not self.hide_emitters:   # directly visible emitters
            if env:
                escaped = active & ~si.is_valid()
                le_env, _ = scene.eval_env(ray, ray.o, escaped)
                L = L + torch.where(escaped[:, None], le_env, 0.0)
            L = L + scene.eval_emitter_hit(si, ray.o, act)[0]

        # ---- emitter sampling
        for k in range(self.emitter_samples):
            ds, em_weight, ok = scene.sample_emitter_direction(
                si, rng.sample_1d(seed, lane, bounce_dim(k, SLOT_EM_SELECT)),
                rng.sample_2d(seed, lane, bounce_dim(k, SLOT_EM_POS)), act,
                ctx)
            bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d), ok)
            mis = torch.where(ds.delta, 1.0,
                              mis_weight(ds.pdf * frac_em, bsdf_pdf * frac_bs))
            L = L + bsdf_val * em_weight * (
                weight_em * torch.where(ok, mis, 0.0))[:, None]

        # ---- BSDF sampling
        for k in range(self.bsdf_samples):
            bs, bsdf_w = scene.bsdf_sample(
                si, rng.sample_1d(seed, lane, bounce_dim(k, SLOT_BSDF_LOBE)),
                rng.sample_2d(seed, lane, bounce_dim(k, SLOT_BSDF_DIR)), act)
            ray2 = si.spawn_ray(si.to_world(bs.wo))
            ok = act & (bs.pdf > 0.0)
            si2 = scene.ray_intersect(ray2, ok, ctx)
            hit2 = ok & si2.is_valid()
            le2, pdf_em2 = scene.eval_emitter_hit(si2, si.p, hit2)
            if env:   # or the environment, where the ray escapes
                le_env2, pdf_env2 = scene.eval_env(ray2, si.p,
                                                   ok & ~si2.is_valid())
                le2 = torch.where(hit2[:, None], le2, le_env2)
                pdf_em2 = torch.where(hit2, pdf_em2, pdf_env2)
            mis = torch.where(bs.delta, 1.0,
                              mis_weight(bs.pdf * frac_bs, pdf_em2 * frac_em))
            L = L + bsdf_w * le2 * (
                weight_bs * torch.where(ok, mis, 0.0))[:, None]
        return L
