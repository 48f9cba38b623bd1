"""Perspective pinhole camera (mitsuba_tpu/models/sensors.py;
reference src/sensors/perspective.cpp).

Camera space has +z forward, +y up and +x pointing image-left
(transform.h look_at stores the left vector in column 0); film samples
live in [0,1)^2 with (0,0) the top-left corner; importance weights are 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..core import transform as tf
from ..core.math import normalize
from ..core.records import Ray
from .film import Film
from .samplers import IndependentSampler


def _fov_to_tan_x(fov_deg, fov_axis: str, width: int, height: int,
                  device=None):
    """Half-tangent of the horizontal (x) field of view, as float32,
    computed on the CPU (its tan's bits on every device)."""
    t = torch.tan(0.5 * torch.deg2rad(
        torch.tensor(fov_deg, dtype=torch.float32)))
    aspect = width / height
    if fov_axis == "y":
        t = t * aspect
    elif fov_axis == "smaller":
        t = t if aspect >= 1.0 else t * aspect
    elif fov_axis == "larger":
        t = t if aspect <= 1.0 else t * aspect
    elif fov_axis == "diagonal":
        t = t / math.sqrt(1.0 + 1.0 / (aspect * aspect))
    elif fov_axis != "x":
        raise ValueError(f"unknown fov_axis {fov_axis!r}")
    return t.to(device)


@dataclass
class PerspectiveCamera:
    """Pinhole camera (src/sensors/perspective.cpp)."""

    to_world: torch.Tensor          # (4, 4) float32, on the scene's device
    film: Film = field(default_factory=Film)
    fov: float = 39.3077
    fov_axis: str = "x"
    near_clip: float = 1e-2
    far_clip: float = 1e4
    sampler: IndependentSampler = field(default_factory=IndependentSampler)

    def sample_ray(self, position_sample):
        """Film position in [0,1)^2 (N, 2) -> (Ray, importance weight (N, 3))."""
        w, h = self.film.width, self.film.height
        tx = _fov_to_tan_x(self.fov, self.fov_axis, w, h,
                           device=position_sample.device)
        aspect = w / h
        u = position_sample[..., 0]
        v = position_sample[..., 1]
        x = (1.0 - 2.0 * u) * tx
        y = (1.0 - 2.0 * v) * tx / aspect
        d_cam = normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
        d = tf.apply_vector(self.to_world, d_cam)
        o = torch.broadcast_to(self.to_world[:3, 3], d.shape)
        # near/far clipping along the camera z axis (perspective.cpp)
        inv_z = 1.0 / d_cam[..., 2]
        o = o + d * (self.near_clip * inv_z)[..., None]
        maxt = (self.far_clip - self.near_clip) * inv_z
        return Ray(o=o, d=d, maxt=maxt), torch.ones_like(d)
