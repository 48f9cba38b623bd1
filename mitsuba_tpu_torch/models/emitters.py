"""Emitters (mitsuba_tpu/models/emitters.py): the area light, the fork's
collimated area source (``DirectionalAreaEmitter``, the field source of
the lens-design path), the lat-long environment map, the delta lights
(``PointEmitter``, ``SpotEmitter``, ``ProjectorEmitter``) and the
infinite ``ConstantEmitter`` and ``DirectionalEmitter``.

A geometry-bound emitter receives its mesh through ``geom = (mesh,
face_distr)``, owned by the Scene; the infinite emitters take no
geometry but the scene's bounding sphere, which ``make_scene`` gives
them.  Every emitter's ``sample_ray`` emits the particle tracer's
particles (``Scene.sample_emitter_ray``).  A delta light's NEE sample
carries pdf 1 and ``delta`` set, so the integrators give it MIS weight 1
and no ray hits it.  The megakernels (ops/megakernel.py) carry the area
light and the environment map in their packed tables; a scene with any
other emitter takes the wavefront path.  An area light on an analytic
sphere receives ``geom = (SphereGeom, None)`` and samples the sphere's
visible cone (models/analytic.py; emitters.py:45-133 of the JAX
package).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import transform as tf
from ..core import warp
from ..core.distr2d import Marginal2D
from ..core.math import (Frame, cross, dot, normalize, safe_div, safe_sqrt,
                         sqrt, via_f64)
from ..core.records import DirectionSample, PositionSample, Ray
from ..device import resolve_device
from .analytic import SphereGeom, _acos, _phi

# dOmega = 2 pi^2 sin(theta) dA_uv: the uv-area to solid-angle factor
UV_TO_SOLID_ANGLE = 2.0 * math.pi ** 2
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


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
        if isinstance(mesh, SphereGeom):
            return self._sample_direction_sphere(ref_p, mesh, sample2)
        ps = mesh.sample_position(sample1, sample2, face_distr)
        delta = ps.p - ref_p
        dist2 = torch.clamp(dot(delta, delta), min=1e-12)
        dist = sqrt(dist2)
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

    def _sample_direction_sphere(self, ref_p, geom, sample2):
        """Solid-angle cone sampling toward an analytic sphere
        (sphere.cpp:236-287); from inside it, a uniform position with its
        area pdf converted."""
        p_c, n_c, pdf_c, outside = geom.cone_sample_direction(ref_p, sample2)
        ps = geom.sample_position(None, sample2)
        delta_a = ps.p - ref_p
        dist2_a = torch.clamp(dot(delta_a, delta_a), min=1e-12)
        cos_a = torch.clamp(-dot(delta_a, ps.n) / sqrt(dist2_a),
                            min=1e-6)
        pdf_a = ps.pdf * dist2_a / cos_a
        p = torch.where(outside[:, None], p_c, ps.p)
        n = torch.where(outside[:, None], n_c, ps.n)
        pdf = torch.where(outside, pdf_c, pdf_a)
        delta = p - ref_p
        dist = sqrt(torch.clamp(dot(delta, delta), min=1e-12))
        # the sphere's uv at the sampled point (AnalyticShapes._sphere_si)
        uv = torch.stack([_phi(n[..., 1], n[..., 0]) / (2.0 * math.pi),
                          _acos(torch.clamp(n[..., 2], -1.0, 1.0)) / math.pi],
                         dim=-1)
        zero = torch.zeros(pdf.shape, dtype=torch.int64, device=pdf.device)
        ds = DirectionSample(p=p, n=n, uv=uv, d=delta / dist[..., None],
                             dist=dist, pdf=pdf, delta=zero.bool(),
                             emitter_index=zero)
        weight = torch.where((pdf > 0.0)[..., None],
                             self.radiance.eval(ds)
                             / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        return ds, weight

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        """Attached radiance along a detached NEE sample, the PRB
        re-evaluation partner of ``sample_direction`` (emitters.py:134-140
        of the JAX package): the front side emits."""
        front = -dot(ds.d, ds.n) > 1e-6
        if active is not None:
            front = front & active
        return torch.where(front[..., None], self.radiance.eval(ds), 0.0)

    def pdf_direction(self, ref_p, ds, geom):
        """Solid-angle pdf of ``sample_direction`` having produced ``ds``
        (a sphere's: the cone's, sphere.cpp:311-325)."""
        mesh, _ = geom
        if isinstance(mesh, SphereGeom):
            return mesh.cone_pdf_direction(ref_p, ds)
        cos_emitter = -dot(ds.d, ds.n)
        area_pdf = safe_div(1.0, mesh.surface_area())
        return torch.where(
            cos_emitter > 1e-6,
            area_pdf * ds.dist ** 2 / torch.clamp(cos_emitter, min=1e-6), 0.0)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom):
        """A particle (area.cpp sample_ray): a position uniform by area, a
        cosine-weighted direction about its normal.  Returns (Ray, weight
        = Le * pi / pdf_pos, PositionSample)."""
        mesh, face_distr = geom
        ps = mesh.sample_position_reuse(position_sample, face_distr)
        d_local = warp.square_to_cosine_hemisphere(direction_sample)
        d = Frame.to_world(Frame.from_normal(ps.n), d_local)
        weight = self.radiance.eval(ps) * (
            math.pi / torch.clamp(ps.pdf, min=1e-20))[..., None]
        return _emitted(ps, d), weight, ps


@dataclass
class DirectionalAreaEmitter:
    """Collimated area source: emits only along its surface normal (the
    fork's src/emitters/directionalarea.cpp; the JAX package's
    ``DirectionalAreaEmitter``, emitters.py:168): the field source of the
    lens-design path.  Delta in direction, so no ray hits it and NEE
    never picks it; only the particle tracer's ``sample_ray`` emits."""

    radiance: object              # texture
    sampling_weight: float = 1.0

    is_delta = True

    def eval(self, si, active):
        return torch.zeros(si.uv.shape[:-1] + (3,), device=si.uv.device)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        n, dev = ref_p.shape[0], ref_p.device
        zero = torch.zeros(n, device=dev)
        zero3 = torch.zeros((n, 3), device=dev)
        ds = DirectionSample(
            p=zero3, n=zero3, uv=torch.zeros((n, 2), device=dev), d=zero3,
            dist=zero, pdf=zero,
            delta=torch.ones(n, dtype=torch.bool, device=dev),
            emitter_index=torch.zeros(n, dtype=torch.int64, device=dev))
        return ds, zero3

    def pdf_direction(self, ref_p, ds, geom=None):
        return torch.zeros(ds.pdf.shape, device=ds.pdf.device)

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        return torch.zeros(ds.d.shape[:-1] + (3,), device=ds.d.device)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom):
        """A particle along the normal at a position uniform by area
        (directionalarea.cpp sample_ray).  Returns (Ray, weight = Le /
        pdf_pos, PositionSample)."""
        mesh, face_distr = geom
        ps = mesh.sample_position_reuse(position_sample, face_distr)
        weight = self.radiance.eval(ps) / torch.clamp(ps.pdf,
                                                      min=1e-20)[..., None]
        return _emitted(ps, ps.n), weight, ps


def _emitted(ps, d):
    """The particle leaving the position sample ``ps`` along ``d``, its
    origin 1e-5 off the surface."""
    o = ps.p + 1e-5 * ps.n
    return Ray(o=o, d=d, maxt=torch.full(o.shape[:-1], float("inf"),
                                         device=o.device))


def _tensor(x):
    """A float32 tensor of ``x``, copied from an array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def dir_to_uv(d_env):
    """Lat-long coordinates of local directions (envmap.cpp conventions):
    u = atan2(x, -z) / 2 pi in [0, 1), v = acos(y) / pi."""
    u = via_f64(lambda x: torch.atan2(x, -d_env[..., 2].double()),
                d_env[..., 0]) * (0.5 / math.pi)
    u = u - torch.floor(u)
    v = via_f64(torch.acos, torch.clamp(d_env[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


def uv_to_dir(uv):
    """The local direction of lat-long ``uv`` and its sin(theta)."""
    phi = 2.0 * math.pi * uv[..., 0]
    theta = math.pi * uv[..., 1]
    st, ct = via_f64(torch.sin, theta), via_f64(torch.cos, theta)
    return torch.stack([st * via_f64(torch.sin, phi), ct,
                        -st * via_f64(torch.cos, phi)], dim=-1), st


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
        st = sqrt(torch.clamp(
            1.0 - torch.square(via_f64(torch.cos, math.pi * uv[..., 1])),
            min=1e-12))
        return safe_div(self.distr.pdf(uv),
                        UV_TO_SOLID_ANGLE * torch.clamp(st, min=1e-6))

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        le = bilinear(self.data, self._dir_to_uv(ds.d)) * self.scale
        return le if active is None else torch.where(active[..., None], le,
                                                     0.0)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom=None):
        """An importance-sampled particle entering the scene: a direction
        from the luminance distribution, travelling inward from a disk of
        1.01 times the scene radius across it.  Returns (Ray, weight = Le
        * disk area / pdf_dir, PositionSample)."""
        uv, pdf_uv = self.distr.sample(direction_sample)
        d_out, st = self._uv_to_dir(uv)
        d = -d_out
        r = _f32(self.scene_radius, d) * 1.01
        p = _disk_origin(self.scene_center, d, r, position_sample)
        pdf_dir = safe_div(pdf_uv, UV_TO_SOLID_ANGLE * torch.clamp(st,
                                                                    min=1e-6))
        le = bilinear(self.data, uv) * self.scale
        area = math.pi * r * r
        weight = le * safe_div(area, torch.clamp(pdf_dir, min=1e-20))[..., None]
        n = d.shape[0]
        ps = PositionSample(p=p, n=d, uv=uv, pdf=(1.0 / area).expand(n),
                            delta=torch.zeros(n, dtype=torch.bool,
                                              device=d.device))
        return _ray(p, d), weight, ps


def _f32(x, like):
    """``x`` (a float or a tensor) as a float32 tensor on ``like``'s
    device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _ray(o, d):
    return Ray(o=o, d=d, maxt=torch.full(o.shape[:-1], float("inf"),
                                         device=o.device))


def _disk_origin(center, d, r, position_sample, grouped=False):
    """Points on the disk of radius ``r`` about ``center`` facing the
    unit directions ``d`` (N, 3), pushed back by ``r`` against them: where
    a particle of an infinite emitter starts.  ``grouped`` adds the two
    in-disk offsets together first, as the JAX package's directional
    light does (its environment map adds them one at a time)."""
    p_disk = warp.square_to_uniform_disk_concentric(position_sample) * r
    s, t, _ = Frame.from_normal(d)
    back = _f32(center, d) - d * r
    if grouped:
        return back + (s * p_disk[..., 0:1] + t * p_disk[..., 1:2])
    return back + s * p_disk[..., 0:1] + t * p_disk[..., 1:2]


def _delta_ds(p, d, dist, n):
    """The DirectionSample of a light at ``p`` seen along ``d``: pdf 1,
    delta."""
    dev = d.device
    return DirectionSample(
        p=p, n=-d, uv=torch.zeros((n, 2), device=dev), d=d, dist=dist,
        pdf=torch.ones(n, device=dev),
        delta=torch.ones(n, dtype=torch.bool, device=dev),
        emitter_index=torch.zeros(n, dtype=torch.int64, device=dev))


def _toward(position, ref_p):
    """(unit direction, distance, squared distance) from ``ref_p`` (N, 3)
    to the point ``position`` (3,)."""
    delta = position - ref_p
    dist2 = torch.clamp(dot(delta, delta), min=1e-12)
    dist = sqrt(dist2)
    return delta / dist[..., None], dist, dist2


def _delta_pos(position, d):
    """The PositionSample of a particle leaving the point ``position``
    along ``d``."""
    n = d.shape[0]
    return PositionSample(p=position.expand(n, 3), n=d,
                          uv=torch.zeros((n, 2), device=d.device),
                          pdf=torch.ones(n, device=d.device),
                          delta=torch.ones(n, dtype=torch.bool,
                                           device=d.device))


def _masked(value, active):
    return value if active is None else torch.where(active[..., None], value,
                                                    0.0)


@dataclass
class PointEmitter:
    """Isotropic point light (src/emitters/point.cpp)."""

    intensity: torch.Tensor     # (3,)
    position: torch.Tensor      # (3,)
    sampling_weight: float = 1.0

    is_delta = True

    def eval(self, si, active):
        return torch.zeros(si.uv.shape[:-1] + (3,), device=si.uv.device)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        d, dist, dist2 = _toward(self.position, ref_p)
        weight = self.intensity / dist2[..., None]
        return _delta_ds(self.position.expand(ref_p.shape), d, dist,
                         ref_p.shape[0]), weight

    def pdf_direction(self, ref_p, ds, geom=None):
        return torch.zeros(ds.pdf.shape, device=ds.pdf.device)

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        d2 = torch.clamp(ds.dist * ds.dist, min=1e-12)
        return _masked(self.intensity / d2[..., None], active)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom=None):
        """Uniform-sphere emission; weight = 4 pi I (point.cpp)."""
        d = warp.square_to_uniform_sphere(direction_sample)
        ps = _delta_pos(self.position, d)
        weight = (4.0 * math.pi * self.intensity).expand(d.shape[0], 3)
        return _ray(ps.p, d), weight, ps


@dataclass
class ConstantEmitter:
    """Uniform environment radiance (src/emitters/constant.cpp);
    ``make_scene`` sets ``scene_center`` and ``scene_radius`` (1.01 times
    the scene's bounding radius), so that sampled points lie outside every
    shape."""

    radiance: torch.Tensor      # (3,)
    scene_center: tuple = (0.0, 0.0, 0.0)
    scene_radius: float = 1.0
    sampling_weight: float = 1.0

    is_infinite = True

    def eval_env(self, d, active):
        """Radiance arriving along directions ``d`` (N, 3)."""
        return torch.where(active[..., None],
                           self.radiance.expand(d.shape[:-1] + (3,)), 0.0)

    def eval(self, si, active):
        """The radiance for each lane of ``si`` (the JAX package's, which
        no integrator calls: a ray that escapes reads ``eval_env``)."""
        return self.eval_env(si.uv, active)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        d = warp.square_to_uniform_sphere(sample2)
        n = ref_p.shape[0]
        r = 2.0 * self.scene_radius
        dev = ref_p.device
        ds = DirectionSample(
            p=ref_p + d * r, n=-d, uv=torch.zeros((n, 2), device=dev), d=d,
            dist=torch.full((n,), r, device=dev),
            pdf=torch.full((n,), INV_FOUR_PI, device=dev),
            delta=torch.zeros(n, dtype=torch.bool, device=dev),
            emitter_index=torch.zeros(n, dtype=torch.int64, device=dev))
        return ds, (self.radiance / INV_FOUR_PI).expand(n, 3)

    def pdf_direction(self, ref_p, ds, geom=None):
        return torch.full(ds.pdf.shape, INV_FOUR_PI, device=ds.pdf.device)

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        return _masked(self.radiance.expand(ds.d.shape[:-1] + (3,)), active)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom=None):
        """An inward particle from the bounding sphere (constant.cpp
        sample_ray): a uniform position on the sphere of 1.01 times the
        scene radius, a cosine-weighted direction about the inward
        normal; weight = 4 pi^2 r^2 Le."""
        n = direction_sample.shape[0]
        r = _f32(self.scene_radius, direction_sample) * 1.01
        n_out = warp.square_to_uniform_sphere(position_sample)
        p = _f32(self.scene_center, n_out) + r * n_out
        d_local = warp.square_to_cosine_hemisphere(direction_sample)
        d = Frame.to_world(Frame.from_normal(-n_out), d_local)
        area_w = (4.0 * math.pi ** 2) * r * r
        ps = PositionSample(
            p=p, n=-n_out, uv=torch.zeros((n, 2), device=p.device),
            pdf=(1.0 / ((4.0 * math.pi) * r * r)).expand(n),
            delta=torch.zeros(n, dtype=torch.bool, device=p.device))
        return _ray(p, d), (self.radiance * area_w).expand(n, 3), ps


@dataclass
class DirectionalEmitter:
    """Distant collimated light (src/emitters/directional.cpp):
    ``direction`` is the one the light travels.  Infinite and delta:
    no ray sees it, NEE reaches it with weight ``irradiance``."""

    irradiance: torch.Tensor    # (3,)
    direction: torch.Tensor     # (3,)
    scene_center: tuple = (0.0, 0.0, 0.0)
    scene_radius: float = 1.0
    sampling_weight: float = 1.0

    is_delta = True
    is_infinite = True

    def eval(self, si, active):
        return torch.zeros(si.uv.shape[:-1] + (3,), device=si.uv.device)

    def eval_env(self, d, active):
        return torch.zeros(d.shape[:-1] + (3,), device=d.device)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        n = ref_p.shape[0]
        d = (-normalize(self.direction)).expand(n, 3)
        r = 2.0 * self.scene_radius
        ds = _delta_ds(ref_p + d * r, d,
                       torch.full((n,), r, device=ref_p.device), n)
        return ds, self.irradiance.expand(n, 3)

    def pdf_direction(self, ref_p, ds, geom=None):
        return torch.zeros(ds.pdf.shape, device=ds.pdf.device)

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        return _masked(self.irradiance.expand(ds.d.shape[:-1] + (3,)), active)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom=None):
        """A collimated particle from the scene's bounding disk
        (directional.cpp sample_ray); weight = E pi r^2."""
        n = direction_sample.shape[0]
        d = normalize(self.direction).expand(n, 3)
        r = _f32(self.scene_radius, d) * 1.01
        p = _disk_origin(self.scene_center, d, r, position_sample,
                         grouped=True)
        area = math.pi * r * r
        ps = PositionSample(
            p=p, n=d, uv=torch.zeros((n, 2), device=d.device),
            pdf=(1.0 / area).expand(n),
            delta=torch.zeros(n, dtype=torch.bool, device=d.device))
        return _ray(p, d), (self.irradiance * area).expand(n, 3), ps


@dataclass
class SpotEmitter:
    """Spot light: a point light whose intensity falls off linearly in
    the cosine from ``beam_width`` to ``cutoff_angle`` (degrees) about
    ``direction`` (src/emitters/spot.cpp)."""

    intensity: torch.Tensor     # (3,)
    position: torch.Tensor      # (3,)
    direction: torch.Tensor     # (3,) the beam's axis
    cutoff_angle: float = 20.0
    beam_width: float = 15.0
    sampling_weight: float = 1.0

    is_delta = True

    def _falloff(self, d_out):
        """The falloff for light leaving along ``d_out``."""
        cos_cut = float(np.cos(np.deg2rad(self.cutoff_angle)))
        cos_beam = float(np.cos(np.deg2rad(self.beam_width)))
        cd = dot(normalize(self.direction).expand(d_out.shape), d_out)
        return torch.clamp(safe_div(cd - cos_cut,
                                    _f32(cos_beam - cos_cut, cd)), 0.0, 1.0)

    def eval(self, si, active):
        return torch.zeros(si.uv.shape[:-1] + (3,), device=si.uv.device)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        d, dist, dist2 = _toward(self.position, ref_p)
        weight = self.intensity * (self._falloff(-d) / dist2)[..., None]
        return _delta_ds(self.position.expand(ref_p.shape), d, dist,
                         ref_p.shape[0]), weight

    def pdf_direction(self, ref_p, ds, geom=None):
        return torch.zeros(ds.pdf.shape, device=ds.pdf.device)

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        d2 = torch.clamp(ds.dist * ds.dist, min=1e-12)
        return _masked(
            self.intensity * (self._falloff(-ds.d) / d2)[..., None], active)

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom=None):
        """A particle uniform in the cone within the cutoff; weight = I
        falloff / pdf_dir."""
        cos_cut = float(np.cos(np.deg2rad(self.cutoff_angle)))
        s = direction_sample
        z = 1.0 + s[..., 1] * (cos_cut - 1.0)
        rad = safe_sqrt(1.0 - z * z)
        phi = 2.0 * math.pi * s[..., 0]
        d_local = torch.stack([rad * via_f64(torch.cos, phi),
                               rad * via_f64(torch.sin, phi), z], dim=-1)
        frame = Frame.from_normal(normalize(self.direction).expand(
            d_local.shape))
        d = Frame.to_world(frame, d_local)
        pdf_dir = torch.where(d_local[..., 2] >= cos_cut,
                              (0.5 / math.pi) / (1.0 - cos_cut), 0.0)
        weight = self.intensity * safe_div(self._falloff(d),
                                           pdf_dir)[..., None]
        ps = _delta_pos(self.position, d)
        return _ray(ps.p, d), weight, ps


class _UV:
    """What a texture lookup reads of an interaction: its uv."""

    def __init__(self, uv):
        self.uv = uv


@dataclass
class ProjectorEmitter:
    """Image projector (src/emitters/projector.cpp): a point light whose
    intensity is the texture ``irradiance`` seen through a perspective
    frustum of horizontal field ``fov`` (degrees) about ``direction``,
    ``up`` giving its vertical, times ``scale``.  Nothing leaves outside
    the frustum."""

    irradiance: object          # texture
    position: torch.Tensor      # (3,)
    direction: torch.Tensor     # (3,) optical axis
    up: torch.Tensor            # (3,)
    scale: torch.Tensor         # ()
    fov: float = 45.0
    aspect: float = 1.0
    sampling_weight: float = 1.0

    is_delta = True

    def _frame(self):
        d = normalize(self.direction)
        s = normalize(cross(self.up, d))
        return s, cross(d, s), d

    def _tan(self):
        tx = float(np.tan(np.deg2rad(self.fov) * 0.5))
        return tx, tx / self.aspect

    def _eval_tex(self, d_out, active):
        """The texture's value, times ``scale``, for light leaving along
        world directions ``d_out``: the texture's (u, v) is where d_out
        crosses the image plane, 0 outside the frustum."""
        s, t, ax = (v.expand(d_out.shape) for v in self._frame())
        z, x, y = dot(d_out, ax), dot(d_out, s), dot(d_out, t)
        tx, ty = self._tan()
        inside = z > 1e-6
        zi = torch.where(inside, z, 1.0)
        u = 0.5 * (x / (zi * tx) + 1.0)
        v = 0.5 * (y / (zi * ty) + 1.0)
        inside = inside & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        val = self.irradiance.eval(_UV(torch.stack([u, v], dim=-1)))
        ok = inside if active is None else active & inside
        return torch.where(ok[..., None], val * self.scale, 0.0)

    def eval(self, si, active):
        return torch.zeros(si.uv.shape[:-1] + (3,), device=si.uv.device)

    def sample_direction(self, ref_p, sample1, sample2, geom=None):
        d, dist, dist2 = _toward(self.position, ref_p)
        weight = self._eval_tex(-d, None) / dist2[..., None]
        return _delta_ds(self.position.expand(ref_p.shape), d, dist,
                         ref_p.shape[0]), weight

    def pdf_direction(self, ref_p, ds, geom=None):
        return torch.zeros(ds.pdf.shape, device=ds.pdf.device)

    def eval_direction(self, ref_p, ds, geom=None, active=None):
        d2 = torch.clamp(ds.dist * ds.dist, min=1e-12)
        return self._eval_tex(-ds.d, active) / d2[..., None]

    def sample_ray(self, wavelength_sample, direction_sample, position_sample,
                   geom=None):
        """A particle uniform over the image plane of the frustum; weight
        = the texture's value times 4 tx ty cos^3 (the image-plane pdf
        turned into solid angle)."""
        s, t, ax = self._frame()
        tx, ty = self._tan()
        x = (direction_sample[..., 0] * 2.0 - 1.0) * tx
        y = (direction_sample[..., 1] * 2.0 - 1.0) * ty
        d = normalize(s * x[:, None] + t * y[:, None] + ax[None, :])
        cos_theta = dot(d, ax.expand(d.shape))
        weight = self._eval_tex(d, None) * (4.0 * tx * ty
                                            * cos_theta ** 3)[..., None]
        ps = _delta_pos(self.position, d)
        return _ray(ps.p, d), weight, ps
