"""Adjoint particle tracer: light -> sensor transport
(mitsuba_tpu/models/integrators/ptracer.py; reference
src/integrators/ptracer.cpp and AdjointIntegrator, integrator.cpp:540-640).

Paths start on the emitters (``Scene.sample_emitter_ray``), walk by BSDF
sampling in importance transport, and connect every vertex to the
sensor with ``sensor.sample_direction``, splatting at the film position
it returns (``Film.put``, each sample's filter taps normalised).  The lens-design path
renders its focal spots this way: a collimated source seen through
delta lens interfaces can be rendered no other way.

- Importance-mode BSDF sampling reuses the radiance-mode BSDFs and undoes
  their eta^2 radiance factor by multiplying by bs.eta^2
  (dielectric.cpp applies it only in radiance mode).
- The adjoint shading-normal correction (Veach p. 155) is applied at the
  connection (ptracer.cpp:330-346).
- ``spectral``: one hero wavelength a path, drawn from the visible-range
  distribution; its CIE response over its pdf folds into the throughput,
  and dispersive BSDFs read it through the interaction.
- The random numbers are the JAX package's, dimension for dimension
  (the layout below), so the port draws the same paths lane for lane.
- Every hit query goes through ``scene.ray_intersect`` and every shadow
  ray through ``scene.ray_test``: the hit kernels, on detached rays.
  Gradients reach the scene through the attached ``compute_si`` (the
  vertices and shading normals), the BSDFs' parameters (a dispersive
  glass's IOR and Abbe number) and the splat's filter weights, by plain
  autograd over the depths (the JAX package rematerialises them with
  ``jax.checkpoint``; the port keeps them).
- ``render_ptracer``: W*H*spp light paths, the raw splat sum times 1/spp
  (integrator.cpp:598; the weight channel is not divided out).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...core import rng
from ...core.math import Frame, dot, sqrt
from ...core.records import Ray
from ...core.spectrum import rgb_response_flat, sample_wavelength_visible
from .common import sampler_spec

# dimension layout (ptracer.py:35-47 of the JAX package)
DIM_EM_SELECT = 0
DIM_EM_POS = 1
DIM_EM_DIR = 2
DIM_DIRECT_SENSOR = 3
DIM_WAVELENGTH = 4
DIM_BOUNCE_BASE = 8
DIMS_PER_BOUNCE = 8
SLOT_BSDF_LOBE = 0
SLOT_BSDF_DIR = 1
SLOT_RR = 2
SLOT_SENSOR = 3


def _bdim(depth: int, slot: int) -> int:
    return DIM_BOUNCE_BASE + depth * DIMS_PER_BOUNCE + slot


class _ConnectionSI:
    """What a BSDF evaluation at a connection reads of an interaction."""

    def __init__(self, frame, wi, p, wavelengths):
        self.sh_s, self.sh_t, self.sh_n = frame
        self.wi = wi
        self.p = p
        self.uv = torch.zeros(p.shape[:-1] + (2,), device=p.device)
        self.wavelengths = wavelengths


@dataclass
class ParticleTracerIntegrator:
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    spectral: bool = False

    def _connect_sensor(self, scene, sensor, si_p, si_n, si_frame, si_wi,
                        bsdf_idx, weight, sample2, active, ctx, wavelengths):
        """Connect vertices on surfaces to the sensor (ptracer.cpp:298-372
        connect_sensor); returns their splat, (H, W, 4).  ``bsdf_idx`` is
        each lane's BSDF, -1 for an emitter's own vertex (foreshortening
        only); ``si_wi`` the local incident direction."""
        ds, sensor_weight = sensor.sample_direction(si_p, sample2, active)
        ok = active & (ds.pdf > 0.0) & (sensor_weight != 0.0).any(dim=-1)

        delta = ds.p - si_p
        dist = sqrt(torch.clamp(dot(delta, delta), min=1e-20))
        d = delta / dist[..., None]
        sign = torch.sign(dot(d, si_n, keepdim=True))
        o = si_p + sign * 1e-4 * torch.clamp(
            torch.amax(torch.abs(si_p), dim=-1, keepdim=True), min=1.0) * si_n
        shadow = Ray(o=o, d=d, maxt=dist * (1.0 - 1e-3))
        ok = ok & ~scene.ray_test(shadow, ok, ctx)

        local_d = Frame.to_local(si_frame, d)
        cos_o = Frame.cos_theta(local_d)
        surface_weight = torch.ones(si_p.shape[:-1] + (3,), device=si_p.device)
        no_bsdf = bsdf_idx < 0
        surface_weight = torch.where(
            no_bsdf[..., None],
            surface_weight * torch.clamp(cos_o, min=0.0)[..., None],
            surface_weight)
        if scene.bsdfs:
            si_like = _ConnectionSI(si_frame, si_wi, si_p, wavelengths)
            bsdf_val = torch.zeros(si_p.shape[:-1] + (3,), device=si_p.device)
            for i, b in enumerate(scene.bsdfs):
                m = ~no_bsdf & (bsdf_idx == i)
                v, _ = b.eval_pdf(si_like, local_d, m)
                bsdf_val = torch.where(m[..., None], v, bsdf_val)
            cos_i = Frame.cos_theta(si_wi)
            wi_dot_geo = dot(si_n, Frame.to_world(si_frame, si_wi))
            wo_dot_geo = dot(si_n, d)
            valid = (wi_dot_geo * cos_i > 0.0) & (wo_dot_geo * cos_o > 0.0)
            corr = torch.where(valid, torch.abs(
                (cos_i * wo_dot_geo) / torch.clamp(
                    torch.abs(cos_o * wi_dot_geo), min=1e-12)), 0.0)
            surface_weight = torch.where(
                no_bsdf[..., None], surface_weight, corr[..., None] * bsdf_val)
        value = weight * sensor_weight * surface_weight
        return sensor.film.put(ds.uv, value, ok)

    def sample_light_paths(self, scene, sensor, lane, seed, img):
        """One light path a lane; returns ``img`` plus their splats."""
        n = lane.shape[0]
        dev = lane.device
        sampler_spec(scene)
        ctx = scene.trace_ctx()
        lane = rng.as_u32(lane)
        sel = rng.sample_1d(seed, lane, DIM_EM_SELECT)
        pos_s = rng.sample_2d(seed, lane, DIM_EM_POS)
        dir_s = rng.sample_2d(seed, lane, DIM_EM_DIR)
        active0 = torch.ones(n, dtype=torch.bool, device=dev)
        ray, throughput, ps, em_idx = scene.sample_emitter_ray(
            sel, dir_s, pos_s, active0)
        if self.spectral:
            lam, lam_pdf = sample_wavelength_visible(
                rng.sample_1d(seed, lane, DIM_WAVELENGTH))
            throughput = throughput * (rgb_response_flat(lam) / torch.clamp(
                lam_pdf, min=1e-12)[..., None])
            ray.wavelengths = lam[..., None]
        active = active0 & (throughput != 0.0).any(dim=-1)

        # the emitters' own vertices (sample_visible_emitters,
        # ptracer.cpp:97-171): a delta-direction or infinite emitter does
        # not connect, so a scene of only such emitters skips the query
        direct = [i for i, e in enumerate(scene.emitters)
                  if not getattr(e, "is_delta", False)
                  and not getattr(e, "is_infinite", False)]
        if direct and not self.hide_emitters and self.max_depth != 0:
            takes = torch.zeros(n, dtype=torch.bool, device=dev)
            for i in direct:
                takes = takes | (em_idx == i)
            # throughput = Le pi / pdf; the connection wants Le / pdf, its
            # cosine applied as the foreshortening
            conn_w = torch.where(takes[:, None], throughput / math.pi, 0.0)
            wi = torch.zeros((n, 3), device=dev)
            wi[:, 2] = 1.0
            img = img + self._connect_sensor(
                scene, sensor, ps.p, ps.n, Frame.from_normal(ps.n), wi,
                torch.full((n,), -1, dtype=torch.int64, device=dev), conn_w,
                rng.sample_2d(seed, lane, DIM_DIRECT_SENSOR),
                takes & (conn_w != 0.0).any(dim=-1), ctx, ray.wavelengths)

        beta = throughput
        eta = torch.ones(n, device=dev)
        act = active & (self.max_depth > 1)
        for depth in range(1, self.max_depth):
            if not bool(act.any()):
                break
            si = scene.ray_intersect(ray, act, ctx)
            act = act & si.is_valid()
            img = img + self._connect_sensor(
                scene, sensor, si.p, si.n, si.sh_frame, si.wi,
                scene.lane_bsdf_index(si), beta,
                rng.sample_2d(seed, lane, _bdim(depth, SLOT_SENSOR)), act,
                ctx, si.wavelengths)
            bs, bw = scene.bsdf_sample(
                si, rng.sample_1d(seed, lane, _bdim(depth, SLOT_BSDF_LOBE)),
                rng.sample_2d(seed, lane, _bdim(depth, SLOT_BSDF_DIR)), act)
            # importance transport: undo the radiance-only eta^2
            beta = beta * (bw * torch.square(bs.eta)[..., None])
            eta = eta * torch.where(act, bs.eta, 1.0)
            ray = si.spawn_ray(si.to_world(bs.wo))
            act = act & (bs.pdf > 0.0) & (beta > 0.0).any(dim=-1)
            # russian roulette (ptracer.cpp:266-276), its probability
            # detached
            if depth + 1 >= self.rr_depth:
                rr_prob = torch.clamp(
                    (beta.amax(dim=-1) * eta * eta).detach(), max=0.95)
                u = rng.sample_1d(seed, lane, _bdim(depth, SLOT_RR))
                beta = torch.where(
                    act[..., None],
                    beta / torch.clamp(rr_prob, min=1e-8)[..., None], beta)
                act = act & (u < rr_prob)
        return img


def render_ptracer(scene, integrator, seed: int = 0, spp: int | None = None):
    """W*H*spp light paths; the raw splat sum times 1/spp, (H, W, 3)
    (AdjointIntegrator::render, integrator.cpp:544-640)."""
    film = scene.sensor.film
    if spp is None:
        spp = scene.sensor.sampler.sample_count
    n = film.width * film.height * spp
    lane = torch.arange(n, dtype=torch.int32, device=scene.device)
    img0 = torch.zeros((film.height, film.width, 4), device=scene.device)
    img = integrator.sample_light_paths(scene, scene.sensor, lane, seed, img0)
    return img[..., :3] * (1.0 / spp)
