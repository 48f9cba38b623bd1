"""Emitters (mitsuba_tpu/models/emitters.py): the area light and the
lat-long environment map.

A geometry-bound emitter receives its mesh through ``geom = (mesh,
face_distr)``, owned by the Scene; the environment map takes no geometry
but the scene's bounding sphere, which ``make_scene`` gives it.  The
megakernels (ops/megakernel.py) carry the same emitters in their packed
tables.  The JAX package's analytic-sphere branch and the other emitter
types are not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import transform as tf
from ..core.distr2d import Marginal2D
from ..core.math import Frame, dot, safe_div
from ..core.records import DirectionSample
from ..device import resolve_device

# dOmega = 2 pi^2 sin(theta) dA_uv: the uv-area to solid-angle factor
UV_TO_SOLID_ANGLE = 2.0 * math.pi ** 2


@dataclass
class AreaEmitter:
    """Diffuse area light attached to a shape (src/emitters/area.cpp)."""

    radiance: object              # texture
    sampling_weight: float = 1.0  # relative emitter selection probability

    def eval(self, si, active):
        """Radiance toward ``si.wi``: the front side emits."""
        front = Frame.cos_theta(si.wi) > 0.0
        return torch.where((active & front)[..., None],
                           self.radiance.eval(si), 0.0)

    def sample_direction(self, ref_p, sample1, sample2, geom):
        """NEE sample toward the light from ``ref_p``: (DirectionSample,
        Le / pdf), solid-angle measure."""
        mesh, face_distr = geom
        ps = mesh.sample_position(sample1, sample2, face_distr)
        delta = ps.p - ref_p
        dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-12)
        dist = torch.sqrt(dist2)
        d = delta / dist[..., None]
        cos_emitter = -dot(d, ps.n)
        pdf = torch.where(cos_emitter > 1e-6,
                          ps.pdf * dist2 / torch.clamp(cos_emitter, min=1e-6),
                          0.0)
        weight = torch.where((pdf > 0.0)[..., None],
                             self.radiance.eval(ps)
                             / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        zero = torch.zeros(pdf.shape, dtype=torch.int64, device=pdf.device)
        return DirectionSample(p=ps.p, n=ps.n, uv=ps.uv, d=d, dist=dist,
                               pdf=pdf, delta=zero.bool(),
                               emitter_index=zero), weight

    def pdf_direction(self, ref_p, ds, geom):
        """Solid-angle pdf of ``sample_direction`` having produced ``ds``."""
        mesh, _ = geom
        cos_emitter = -dot(ds.d, ds.n)
        area_pdf = safe_div(1.0, mesh.surface_area())
        return torch.where(
            cos_emitter > 1e-6,
            area_pdf * ds.dist ** 2 / torch.clamp(cos_emitter, min=1e-6), 0.0)


def _tensor(x):
    """A float32 tensor of ``x``, copied from an array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def _f64(fn, x):
    """``fn`` of a float32 tensor, computed in float64 and rounded: the
    JAX package's float32 trig is correctly rounded, torch's not always."""
    return fn(x.double()).to(x.dtype)


def dir_to_uv(d_env):
    """Lat-long coordinates of local directions (envmap.cpp conventions):
    u = atan2(x, -z) / 2 pi in [0, 1), v = acos(y) / pi."""
    u = _f64(lambda x: torch.atan2(x, -d_env[..., 2].double()),
             d_env[..., 0]) * (0.5 / math.pi)
    u = u - torch.floor(u)
    v = _f64(torch.acos, torch.clamp(d_env[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


def uv_to_dir(uv):
    """The local direction of lat-long ``uv`` and its sin(theta)."""
    phi = 2.0 * math.pi * uv[..., 0]
    theta = math.pi * uv[..., 1]
    st, ct = _f64(torch.sin, theta), _f64(torch.cos, theta)
    return torch.stack([st * _f64(torch.sin, phi), ct,
                        -st * _f64(torch.cos, phi)], dim=-1), st


def bilinear(data, uv):
    """Bilinear lookup of (H, W, C) texels at lat-long ``uv``: x wraps, y
    clamps (envmap.py _bilinear of the JAX package)."""
    h, w = int(data.shape[0]), int(data.shape[1])
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return (data[y0i, x0i] * (1 - fx) * (1 - fy)
            + data[y0i, x1i] * fx * (1 - fy)
            + data[y1i, x0i] * (1 - fx) * fy + data[y1i, x1i] * fx * fy)


def luminance_table(data):
    """The environment map's sampling weights (envmap.cpp): luminance
    times sin(theta) at each row's centre, plus 1e-12, rounded to float32
    as in the JAX package (luminance in float32, the product in
    float64)."""
    d = np.asarray(data, np.float32)
    lum = 0.2126 * d[..., 0] + 0.7152 * d[..., 1] + 0.0722 * d[..., 2]
    h = d.shape[0]
    theta = (np.arange(h) + 0.5) / h * np.pi
    return (lum * np.sin(theta)[:, None] + 1e-12).astype(np.float32)


@dataclass
class EnvmapEmitter:
    """Lat-long environment map with luminance importance sampling
    (src/emitters/envmap.cpp; the JAX package's ``EnvmapEmitter``).

    Directions: u = atan2(d.x, -d.z) / 2 pi, v = acos(d.y) / pi in the
    map's frame, y up; ``to_world`` rotates that frame into the world.
    ``make_scene`` sets ``scene_center`` and ``scene_radius`` (1.01 times
    the scene's bounding radius); an NEE sample lies at twice that radius.
    """

    data: torch.Tensor        # (H, W, 3) radiance texels
    distr: Marginal2D         # over (H, W), luminance x sin(theta)
    scale: torch.Tensor       # () radiance scale
    to_world: torch.Tensor    # (4, 4) rotation
    scene_center: tuple = (0.0, 0.0, 0.0)
    scene_radius: float = 1.0
    sampling_weight: float = 1.0

    is_infinite = True

    @staticmethod
    def create(data, scale=1.0, to_world=None, device=None, distr=None):
        """From (H, W, 3) radiance ``data`` on ``device`` (default: the
        GPU; pass ``device="cpu"`` for the CPU); ``distr``, when given, is
        the sampling distribution to use instead of one built from the
        luminance table."""
        data = _tensor(data).to(resolve_device(device))
        dev = data.device
        if distr is None:
            distr = Marginal2D.create(torch.as_tensor(
                luminance_table(data.cpu().numpy()), device=dev))
        to_world = torch.eye(4) if to_world is None else _tensor(to_world)
        return EnvmapEmitter(data=data, distr=distr,
                             scale=torch.as_tensor(scale, dtype=torch.float32,
                                                   device=dev),
                             to_world=to_world.to(dev))

    def _dir_to_uv(self, d_world):
        return dir_to_uv(tf.apply_vector(tf.inverse(self.to_world), d_world))

    def _uv_to_dir(self, uv):
        d, st = uv_to_dir(uv)
        return tf.apply_vector(self.to_world, d), st

    def eval_env(self, d, active):
        """Radiance arriving along world directions ``d`` (N, 3)."""
        val = bilinear(self.data, self._dir_to_uv(d)) * self.scale
        return torch.where(active[..., None], val, 0.0)

    def eval(self, si, active):
        """No surface emits: zero."""
        return torch.zeros(si.uv.shape[:-1] + (3,), device=si.uv.device)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        """NEE sample: a direction from the luminance distribution, its
        point at twice the scene radius; (DirectionSample, Le / pdf)."""
        uv, pdf_uv = self.distr.sample(sample2)
        d, st = self._uv_to_dir(uv)
        pdf = safe_div(pdf_uv, UV_TO_SOLID_ANGLE * torch.clamp(st, min=1e-6))
        le = bilinear(self.data, uv) * self.scale
        weight = torch.where((pdf > 0.0)[..., None],
                             le / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        n = ref_p.shape[0]
        r = 2.0 * self.scene_radius
        zero = torch.zeros(n, dtype=torch.int64, device=ref_p.device)
        return DirectionSample(
            p=ref_p + d * r, n=-d, uv=uv, d=d,
            dist=torch.full((n,), r, device=ref_p.device), pdf=pdf,
            delta=zero.bool(), emitter_index=zero), weight

    def pdf_direction(self, ref_p, ds, geom=None):
        """Solid-angle pdf of ``sample_direction`` having produced ``ds``."""
        uv = self._dir_to_uv(ds.d)
        st = torch.sqrt(torch.clamp(
            1.0 - torch.square(_f64(torch.cos, math.pi * uv[..., 1])),
            min=1e-12))
        return safe_div(self.distr.pdf(uv),
                        UV_TO_SOLID_ANGLE * torch.clamp(st, min=1e-6))

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        le = bilinear(self.data, self._dir_to_uv(ds.d)) * self.scale
        return le if active is None else torch.where(active[..., None], le,
                                                     0.0)

    def sample_ray(self, *args, **kw):
        raise NotImplementedError(
            "EnvmapEmitter.sample_ray serves the particle tracer, which is "
            "not ported yet (ROADMAP.md, Queue 1, item 4)")
