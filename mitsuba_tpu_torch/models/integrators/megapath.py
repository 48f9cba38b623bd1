"""Megakernel path-tracer integrator (mitsuba_tpu/models/integrators/megapath.py).

Scenes inside the ported megakernel subset run the whole bounce loop in
one launch of ops/megakernel.py.  Only the brute-force branch is ported:
a scene outside the subset raises ``NotImplementedError`` instead of
falling back, because neither the wavefront ``PathIntegrator`` nor the
BVH kernels exist in the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...ops.megakernel import megakernel_applicable, megakernel_trace, pack_scene


@dataclass
class MegakernelPathIntegrator:
    max_depth: int = 6
    rr_depth: int = 5

    def sample(self, scene, ray, lane, seed, active):
        """Per-lane radiance (N, 3) for the primary rays ``ray``."""
        if not megakernel_applicable(scene):
            raise NotImplementedError(
                "scene outside the ported megakernel subset (constant-"
                "diffuse flat triangle meshes, one constant area light of "
                "at most 16 faces, at most 1024 faces, independent "
                "sampler). ROADMAP.md, 'Port queue': the other "
                "megakernel_trace variants are item 1, the wavefront "
                "PathIntegrator item 2, the BVH path item 3")
        tris, light, n_faces, n_lights = pack_scene(scene)
        return megakernel_trace(
            tris, light, lane, ray.o, ray.d, active, seed,
            max_depth=self.max_depth, rr_depth=self.rr_depth,
            n_faces=n_faces, n_lights=n_lights)
