"""Depth integrator (mitsuba_tpu/models/integrators/depth.py; reference
src/integrators/depth.cpp): each lane's distance to its first hit, 0 on a
miss, in all three channels.  Its hit query is the scene's, as the
wavefront ``PathIntegrator``'s: ``intersect_packed`` without a BVH,
``packet_closest_hit`` with one."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DepthIntegrator:
    def sample(self, scene, ray, lane, seed, active):
        """Per-lane depth (N, 3)."""
        si = scene.ray_intersect(ray, active, scene.trace_ctx())
        d = torch.where(si.is_valid(), si.t, 0.0)
        return d[:, None].expand(d.shape[0], 3)
