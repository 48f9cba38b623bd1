"""Perspective pinhole camera (mitsuba_tpu/models/sensors.py;
reference src/sensors/perspective.cpp).

Camera space has +z forward, +y up and +x pointing image-left
(transform.h look_at stores the left vector in column 0); film samples
live in [0,1)^2 with (0,0) the top-left corner; importance weights are 1.
``sample_direction`` is the particle tracer's connection to the sensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..core import transform as tf
from ..core.math import dot, normalize, sqrt
from ..core.records import DirectionSample, Ray
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

    needs_aperture_sample = False
    spectral = False

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample):
        """Film position in [0,1)^2 (N, 2) -> (Ray, importance weight (N, 3)).
        A pinhole uses neither the time, the wavelength nor the aperture
        sample (the arguments of every sensor's ``sample_ray``)."""
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

    def sample_direction(self, ref_p, sample2, active):
        """The connection from points ``ref_p`` (N, 3) to the pinhole
        (perspective.cpp:283-321; sensors.py:110 of the JAX package): a
        delta position at the camera's origin, importance 1 / (A_img *
        cos^3) / dist^2.  Returns (DirectionSample: p the pinhole, d from
        ``ref_p`` toward it, uv the film position in pixels, pdf 1 where
        the point projects inside the film and the clip range, else 0;
        weight (N, 3)).  The pose is inverted on the host
        (``transform.inverse``), whose gradient reaches ``to_world``, so
        the film position and the weight carry the pose's gradient."""
        n, dev = ref_p.shape[0], ref_p.device
        w, h = self.film.width, self.film.height
        tx = _fov_to_tan_x(self.fov, self.fov_axis, w, h, device=dev)
        aspect = w / h
        local = tf.apply_point(tf.inverse(self.to_world), ref_p)
        ok = active & (local[..., 2] >= self.near_clip) \
            & (local[..., 2] <= self.far_clip)
        z = torch.where(torch.abs(local[..., 2]) > 1e-12, local[..., 2], 1.0)
        u = 0.5 - 0.5 * local[..., 0] / (z * tx)
        v = 0.5 - 0.5 * local[..., 1] * aspect / (z * tx)
        ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        dist = sqrt(torch.clamp(dot(local, local), min=1e-20))
        ct = local[..., 2] / dist
        normalization = 1.0 / (4.0 * tx * tx / aspect)
        # double where: 1 / ct^3 on a lane outside would give a NaN adjoint
        ok_ct = ok & (ct > 1e-6)
        ct_safe = torch.where(ok_ct, ct, 1.0)
        importance = torch.where(ok_ct, normalization / ct_safe ** 3, 0.0)
        cam_p = self.to_world[:3, 3].expand(n, 3)
        axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)
        ds = DirectionSample(
            p=cam_p, n=tf.apply_vector(self.to_world, axis),
            uv=torch.stack([u * w, v * h], dim=-1),
            d=(cam_p - ref_p) / dist[..., None], dist=dist,
            pdf=torch.where(ok, 1.0, 0.0),
            delta=torch.ones(n, dtype=torch.bool, device=dev),
            emitter_index=torch.zeros(n, dtype=torch.int64, device=dev))
        weight = (importance / (dist * dist))[..., None].expand(n, 3)
        return ds, weight
