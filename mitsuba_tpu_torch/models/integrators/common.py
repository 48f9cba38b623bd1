"""Integrator common machinery: sampler-dimension layout, MIS weight,
primary-ray generation and the render loop (mitsuba_tpu/models/integrators/common.py;
reference src/render/integrator.cpp:120-367).

The wavefront is W*H*spp lanes; every random number a lane draws is the
stateless hash of (seed, lane, dim) in core/rng.py, with the fixed
per-bounce dimension slots below.
"""
from __future__ import annotations

import torch

from ...core import rng
from ...device import resolve_device
from ..samplers import IndependentSampler

# ------------------------------------------------------- dimension layout
DIM_POS = 0          # 2D film position jitter
DIM_APERTURE = 1     # 2D aperture sample
DIM_WAVELENGTH = 2   # 1D spectral sample
DIM_TIME = 3         # 1D shutter-time sample (motion blur)
DIM_BOUNCE_BASE = 8  # first per-bounce slot
DIMS_PER_BOUNCE = 8
# per-bounce slots:
SLOT_EM_SELECT = 0   # 1D emitter selection / reuse
SLOT_EM_POS = 1      # 2D emitter position
SLOT_BSDF_LOBE = 2   # 1D BSDF lobe selection
SLOT_BSDF_DIR = 3    # 2D BSDF direction
SLOT_RR = 4          # 1D russian roulette


def bounce_dim(depth: int, slot: int) -> int:
    return DIM_BOUNCE_BASE + depth * DIMS_PER_BOUNCE + slot


def sampler_spec(scene):
    """The stratification spec of the scene's sampler: None, the
    independent sampler, which is the only one ported; the others raise."""
    if not isinstance(scene.sensor.sampler, IndependentSampler):
        raise NotImplementedError(
            f"sampler {type(scene.sensor.sampler).__name__} is not ported: "
            "only the independent sampler is (ROADMAP.md, Queue 1, item 6)")
    return None


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2), ad/integrators/common.py:1318."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-32)
    return torch.where(pdf_a > 0.0, w, 0.0)


def sample_rays(scene, seed, spp: int, spp_pass: int | None = None,
                pass_index: int = 0):
    """Primary-ray wavefront for one spp pass (integrator.cpp:293-310).

    Returns (ray, weight, film_pos, lane).  ``lane`` (int32) is the global
    RNG lane id pixel * spp + sample, invariant to pass splitting; lanes
    are pixel-major with ``spp_pass`` consecutive lanes per pixel.  The
    aperture sample is drawn only for a sensor that
    ``needs_aperture_sample`` (the lens camera) and the wavelength sample
    only for a ``spectral`` one; the others get zeros, which they ignore.
    The RNG is stateless, so skipping a draw changes nothing downstream.
    The shutter time is not drawn: the port's rays carry no time, and
    nothing in the port reads one.
    """
    sensor = scene.sensor
    w, h = sensor.film.width, sensor.film.height
    if spp_pass is None:
        spp_pass = spp
    n = w * h * spp_pass
    i = torch.arange(n, dtype=torch.int32, device=scene.device)
    pixel = i // spp_pass
    lane = pixel * spp + pass_index * spp_pass + (i % spp_pass)
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)

    jitter = rng.sample_2d(seed, lane, DIM_POS)
    jitter = sensor.sampler.film_jitter(jitter, lane % spp)
    film_pos = torch.stack([px, py], dim=-1) + jitter
    pos_unit = film_pos / torch.tensor([w, h], dtype=torch.float32,
                                       device=scene.device)
    aperture = (rng.sample_2d(seed, lane, DIM_APERTURE)
                if sensor.needs_aperture_sample
                else torch.zeros_like(pos_unit))
    wav = (rng.sample_1d(seed, lane, DIM_WAVELENGTH) if sensor.spectral
           else torch.zeros_like(px))
    ray, weight = sensor.sample_ray(None, wav, pos_unit, aperture)
    return ray, weight, film_pos, lane


def check_device(scene, device):
    """Raises unless the scene lives on ``device`` (default: the GPU,
    raising without one)."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"the scene lives on {scene.device}, not {device}; "
                         "build it with the same device")


def render(scene, integrator=None, seed: int = 0, spp: int | None = None,
           device=None, spp_per_pass: int | None = None):
    """Full primal render: wavefront -> integrator.sample -> splat -> develop.

    Runs on ``device`` (default: the GPU), which must be the scene's.
    ``integrator`` defaults to the scene's own (a loaded scene's, as
    ``mi.render(scene)``), ``spp`` to the sensor sampler's sample count.  With
    ``spp_per_pass`` the spp are split into passes (integrator.cpp:249-265)
    accumulated in image space before the develop division.  The particle
    tracer renders by its own loop, ``render_ptracer``, in one pass
    (common.py:132-135 of the JAX package).
    Returns the (H, W, 3) image.
    """
    from .ptracer import ParticleTracerIntegrator, render_ptracer

    check_device(scene, device)
    if integrator is None:
        integrator = scene.integrator
        if integrator is None:
            raise ValueError("the scene has no integrator of its own: pass "
                             "one")
    if isinstance(integrator, ParticleTracerIntegrator):
        return render_ptracer(scene, integrator, seed, spp)
    film = scene.sensor.film
    if spp is None:
        spp = scene.sensor.sampler.sample_count
    if spp_per_pass is None or spp_per_pass >= spp:
        passes = [(0, spp)]
    else:
        if spp % spp_per_pass:
            raise ValueError(f"spp {spp} is not a multiple of "
                             f"spp_per_pass {spp_per_pass}")
        passes = [(p, spp_per_pass) for p in range(spp // spp_per_pass)]
    image = None
    for pass_index, spp_pass in passes:
        img = _render_pass(scene, integrator, seed, spp, spp_pass, pass_index)
        image = img if image is None else image + img
    return film.develop(image)


def _render_pass(scene, integrator, seed, spp, spp_pass, pass_index):
    ray, weight, film_pos, lane = sample_rays(scene, seed, spp, spp_pass,
                                              pass_index)
    active = torch.ones(ray.o.shape[0], dtype=torch.bool, device=scene.device)
    L = integrator.sample(scene, ray, lane, seed, active)
    # spp normalization happens in develop() through the filter-weight
    # channel; lanes are pixel-major, so the scatter-free splat applies
    return scene.sensor.film.put_grouped(film_pos, L * weight, spp_pass,
                                         active)
