"""Megakernel path-tracer integrator (mitsuba_tpu/models/integrators/megapath.py).

Scenes inside the ported plugin subset (diffuse, bitmap-textured
diffuse, smooth and rough conductors, dielectrics and plastics, and the
two-sided wrapper: ops/megakernel.py ``bsdf_code``; an area light, an
environment map or both) take one of two kernel families:
up to ``MAX_FACES`` faces the brute kernel (ops/megakernel.py) runs the
whole bounce loop in one launch; above it the scene carries a BVH and
the BVH kernels (ops/megakernel_bvh.py) run, by default one launch per
depth with the lanes re-sorted by a coherence key in between
(``sort_bounces``), else one launch for every depth over Morton-ordered
lanes.  A textured BVH scene, and one lit by an environment map, always
takes the per-depth pipeline, as in the JAX package: the single launch
takes no texture arena and no environment map.  Lane ids
ride every permutation, so all three give the same per-lane radiance.  A scene outside the subset, or whose BVH is deeper
than the BVH kernels' walk takes, falls back to the wavefront
``PathIntegrator``, as in the JAX package, and says so in the log (a
point, spot, projector, constant or directional light among them); with
``strict=True`` it raises ``ValueError`` instead.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ...ops.megakernel import (megakernel_applicable, megakernel_trace,
                               pack_scene, plugin_subset_ok, scene_btypes,
                               textured)
from ...ops.megakernel_bvh import (STACK_CAP, megakernel_bounce_bvh,
                                   megakernel_bvh_applicable,
                                   megakernel_trace_bvh, pack_scene_bvh,
                                   primary_state)
from ..emitters import AreaEmitter, EnvmapEmitter
from .path import PathIntegrator

_log = logging.getLogger(__name__)


@lru_cache(maxsize=8)
def _morton_perm(width: int, height: int, n: int):
    """Static wavefront permutation: rays of a full-frame pass, ordered
    pixel-major with spp_pass samples per pixel (common.py sample_rays),
    re-ordered so consecutive lanes cover Morton (Z-order) pixel tiles.
    Returns an int64 numpy permutation, or None when n is not a whole
    number of samples per pixel.  Cached per (width, height, n); callers
    must not modify the array."""
    px_count = width * height
    if px_count == 0 or n % px_count != 0:
        return None
    spp_pass = n // px_count
    x = np.arange(width, dtype=np.uint64)
    y = np.arange(height, dtype=np.uint64)

    def spread(v):
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    code = (spread(x)[None, :] | (spread(y)[:, None] << np.uint64(1)))
    order = np.argsort(code.reshape(-1), kind="stable").astype(np.int64)
    return (order[:, None] * spp_pass
            + np.arange(spp_pass, dtype=np.int64)[None, :]).reshape(-1)


def _part1by2(x):
    """Spread 10 bits to every 3rd position (Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _bounce_sort_key(state, center, inv_r):
    """Coherence key for per-bounce re-sorting: direction octant (high
    bits) then Morton-coded position cell; dead lanes sort to the end."""
    ox, oy, oz, dx, dy, dz = state[:6]
    octant = ((dx >= 0).to(torch.int32) + 2 * (dy >= 0).to(torch.int32)
              + 4 * (dz >= 0).to(torch.int32))

    def q(p, c):
        t = (p - c) * inv_r * 0.5 + 0.5
        return torch.clamp(t * 127.0, 0.0, 127.0).to(torch.int32)

    m = (_part1by2(q(ox, center[0]))
         | (_part1by2(q(oy, center[1])) << 1)
         | (_part1by2(q(oz, center[2])) << 2))
    key = (octant << 21) | m
    return torch.where(state[15] > 0.5, key, 0x7FFFFFFF)


def _gather(p, state, lane_c, idx):
    """Permute the (16, N) state, the lane ids and the lane order by ``p``."""
    return state[:, p], lane_c[p], idx[p]


def _resort(state, lane_c, idx, center, inv_r):
    """One re-sort of the per-depth pipeline: stable argsort of
    ``_bounce_sort_key``, then the gather."""
    p = torch.argsort(_bounce_sort_key(state, center, inv_r), stable=True)
    return _gather(p, state, lane_c, idx)


@dataclass
class MegakernelPathIntegrator:
    max_depth: int = 6
    rr_depth: int = 5
    # raise instead of falling back for a scene outside the subset
    strict: bool = False
    # BVH scenes: one kernel launch per depth with the lanes re-sorted by
    # (direction octant, position cell) in between, instead of one launch
    # for every depth; the same per-lane radiance either way.  A textured
    # scene, and one with an environment map, takes the per-depth
    # launches whatever this says.
    sort_bounces: bool = True
    # re-sort every k-th depth only
    sort_every: int = 1

    def sample(self, scene, ray, lane, seed, active):
        """Per-lane radiance (N, 3) for the primary rays ``ray``."""
        smooth = any(m.normals is not None for m in scene.meshes)
        if megakernel_applicable(scene):
            tris, light, n_faces, n_lights, tex, env = pack_scene(scene)
            return megakernel_trace(
                tris, light, lane, ray.o, ray.d, active, seed,
                max_depth=self.max_depth, rr_depth=self.rr_depth,
                n_faces=n_faces, n_lights=n_lights, smooth=smooth,
                btypes=scene_btypes(scene), tex=tex, **env)
        if not megakernel_bvh_applicable(scene):
            if scene.scene_analytic is not None:
                why = (f"the scene holds "
                       f"{scene.scene_analytic.n_prims} analytic prims "
                       "(exact spheres, disks, cylinders, curves), which "
                       "the megakernels do not intersect")
            elif scene.scene_sdf is not None:
                why = ("the scene holds an SDF grid, which the megakernels "
                       "do not intersect")
            elif scene.instances:
                why = (f"the scene holds {len(scene.instances)} instanced "
                       "groups, which the megakernels do not intersect")
            elif any(not isinstance(e, (AreaEmitter, EnvmapEmitter))
                     for e in scene.emitters):
                names = sorted({type(e).__name__ for e in scene.emitters
                                if not isinstance(e, (AreaEmitter,
                                                      EnvmapEmitter))})
                why = (f"the scene holds {', '.join(names)}, which the "
                       "megakernels do not sample (they take one area "
                       "light and one environment map)")
            elif not plugin_subset_ok(scene):
                why = ("scene outside the megakernel plugin subset "
                       "(triangle meshes of diffuse, bitmap-textured "
                       "diffuse, conductor, dielectric and plastic BSDFs, "
                       "two-sided but for the dielectrics, at most one "
                       "constant area light of at most 16 faces and at "
                       "most one environment map, each of sampling weight "
                       "1, independent sampler)")
            else:
                why = (f"the BVH is {scene.accel.depth} inner nodes deep, "
                       f"deeper than the BVH megakernels' walk takes "
                       f"({STACK_CAP})")
            if self.strict:
                raise ValueError(why)
            _log.info("megapath: %s: falling back to the wavefront "
                      "PathIntegrator (set strict=True to raise instead)", why)
            return PathIntegrator(max_depth=self.max_depth,
                                  rr_depth=self.rr_depth).sample(
                scene, ray, lane, seed, active)
        tables = pack_scene_bvh(scene)
        btypes = scene_btypes(scene)
        if self.sort_bounces or textured(btypes) or tables.env:
            return self._sorted_bvh(scene, tables, smooth, btypes, lane, ray,
                                    active, seed)
        # Morton-tiled lanes: neighbouring threads walk neighbouring
        # pixels.  Pure reordering; L is scattered back.
        n = ray.o.shape[0]
        film = scene.sensor.film
        perm = _morton_perm(film.width, film.height, n)
        if perm is None:
            return megakernel_trace_bvh(
                tables, lane, ray.o, ray.d, active, seed,
                max_depth=self.max_depth, rr_depth=self.rr_depth,
                smooth=smooth, btypes=btypes)
        p = torch.as_tensor(perm, device=ray.o.device)
        L = megakernel_trace_bvh(
            tables, lane[p], ray.o[p], ray.d[p], active[p], seed,
            max_depth=self.max_depth, rr_depth=self.rr_depth, smooth=smooth,
            btypes=btypes)
        return torch.empty_like(L).index_copy_(0, p, L)

    def _sorted_bvh(self, scene, tables, smooth, btypes, lane, ray, active,
                    seed):
        """Per-bounce pipeline: sort -> one-bounce kernel, repeated."""
        n = ray.o.shape[0]
        dev = ray.o.device
        state = primary_state(ray.o, ray.d, active)
        lane_c = lane.to(torch.int32)
        idx = torch.arange(n, device=dev)
        center = scene.scene_center
        inv_r = 1.0 / max(scene.scene_radius, 1e-6)
        # depth 0: primary rays share the camera cell, so the key would
        # order by octant only; a static Morton order of the pixels gives
        # neighbouring lanes neighbouring pixels instead
        film = scene.sensor.film
        mperm = _morton_perm(film.width, film.height, n)
        if mperm is not None:
            state, lane_c, idx = _gather(torch.as_tensor(mperm, device=dev),
                                         state, lane_c, idx)
        for depth in range(self.max_depth):
            if (depth % max(self.sort_every, 1) == 0
                    and not (depth == 0 and mperm is not None)):
                state, lane_c, idx = _resort(state, lane_c, idx, center, inv_r)
            # once RR and escapes end every path, skip the remaining
            # launches (one host check per depth)
            if not bool((state[15] > 0.5).any()):
                break
            megakernel_bounce_bvh(
                tables, lane_c, seed, state, depth=depth,
                max_depth=self.max_depth, rr_depth=self.rr_depth,
                smooth=smooth, btypes=btypes)
        return torch.empty((n, 3), device=dev).index_copy_(0, idx,
                                                           state[6:9].T)
