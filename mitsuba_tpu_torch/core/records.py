"""Batched interaction records (mitsuba_tpu/core/records.py).

Each record is a dataclass of (N, ...) tensors, one entry per wavefront
lane.  Traversal returns only a ``PreliminaryIntersection``; the
``SurfaceInteraction`` is re-derived from the hit face afterwards
(models/scene.py ``compute_si``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .math import RAY_EPS, Frame, dot


@dataclass
class Ray:
    o: torch.Tensor      # (N, 3) origin
    d: torch.Tensor      # (N, 3) unit direction
    maxt: torch.Tensor   # (N,)


def select(mask, new, old):
    """Field by field ``where(mask, new, old)`` of two records of one type
    (a (N,) bool mask broadcast over each field's trailing dimensions)."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)

    return type(new)(**{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                        for f in dataclasses.fields(new)})


@dataclass
class PreliminaryIntersection:
    t: torch.Tensor            # (N,) hit distance, inf on a miss
    prim_index: torch.Tensor   # (N,) int64 global face index
    prim_uv: torch.Tensor      # (N, 2) barycentrics (b1, b2)
    shape_index: torch.Tensor  # (N,) int64 shape id, -1 on a miss

    def is_valid(self):
        return torch.isfinite(self.t)


@dataclass
class SurfaceInteraction:
    t: torch.Tensor            # (N,)
    p: torch.Tensor            # (N, 3) hit position
    n: torch.Tensor            # (N, 3) geometric normal
    sh_n: torch.Tensor         # (N, 3) shading normal (frame n)
    sh_s: torch.Tensor         # (N, 3) shading frame tangent
    sh_t: torch.Tensor         # (N, 3) shading frame bitangent
    uv: torch.Tensor           # (N, 2)
    wi: torch.Tensor           # (N, 3) incident direction, local frame
    shape_index: torch.Tensor  # (N,) int64, -1 on a miss
    prim_index: torch.Tensor   # (N,) int64

    def is_valid(self):
        return self.shape_index >= 0

    @property
    def sh_frame(self):
        return (self.sh_s, self.sh_t, self.sh_n)

    def to_world(self, v):
        return Frame.to_world(self.sh_frame, v)

    def to_local(self, v):
        return Frame.to_local(self.sh_frame, v)

    def _offset_origin(self, d):
        """p offset along the geometric normal on the side of d.  The
        sign is ``torch.sign``, 0 for d in the tangent plane, as the JAX
        package's ``jnp.sign`` (the megakernels take +1 there)."""
        sign = torch.sign(dot(d, self.n, keepdim=True))
        scale = RAY_EPS * torch.clamp(
            torch.amax(torch.abs(self.p), dim=-1, keepdim=True), min=1.0)
        return self.p + sign * scale * self.n

    def spawn_ray(self, d):
        o = self._offset_origin(d)
        return Ray(o=o, d=d, maxt=torch.full(o.shape[:-1], float("inf"),
                                             device=o.device))

    def spawn_ray_to(self, target):
        """Shadow ray toward ``target``, clipped to (1 - 1e-3) of the
        distance."""
        delta = target - self.p
        dist = torch.sqrt(torch.clamp(torch.sum(delta * delta, dim=-1),
                                      min=1e-20))
        d = delta / dist[..., None]
        return Ray(o=self._offset_origin(d), d=d, maxt=dist * (1.0 - 1e-3))


@dataclass
class PositionSample:
    p: torch.Tensor      # (N, 3)
    n: torch.Tensor      # (N, 3)
    uv: torch.Tensor     # (N, 2)
    pdf: torch.Tensor    # (N,) area-measure pdf
    delta: torch.Tensor  # (N,) bool


@dataclass
class DirectionSample:
    """A direction toward an emitter (NEE), solid-angle measure."""

    p: torch.Tensor              # (N, 3) point on the emitter
    n: torch.Tensor              # (N, 3) emitter normal at p
    uv: torch.Tensor             # (N, 2)
    d: torch.Tensor              # (N, 3) unit direction ref -> p
    dist: torch.Tensor           # (N,)
    pdf: torch.Tensor            # (N,) solid-angle pdf, 0 = invalid
    delta: torch.Tensor          # (N,) bool
    emitter_index: torch.Tensor  # (N,) int64


@dataclass
class BSDFSample:
    wo: torch.Tensor            # (N, 3) sampled direction, local frame
    pdf: torch.Tensor           # (N,)
    eta: torch.Tensor           # (N,) relative IOR along the sampled path
    delta: torch.Tensor         # (N,) bool, Dirac lobe
    sampled_type: torch.Tensor  # (N,) int64 BSDF flags of the lobe
