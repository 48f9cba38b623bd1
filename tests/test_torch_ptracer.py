"""The port's particle tracer against mitsuba_tpu, on the CPU.

One jitted JAX program renders every reference of this file with the
JAX ``ParticleTracerIntegrator`` (``jax_images``): the Cornell box (its
area light connects straight to the sensor), the box with a smooth glass
slab under its light (importance-mode eta^2), and the box with that slab
a ``DispersiveDielectric`` (n_d 1.6, V_d 20) traced spectrally, so that
each path's hero wavelength sets the glass's IOR.  The same (seed, lane,
dim) streams drive both packages, so the port's images must match within
rtol 1e-5, atol 1e-6 (the bar of tests/test_prb.py).  The estimator
itself is held against the port's path integrator on the Cornell box, by
the bars of tests/test_ptracer.py ``test_ptracer_matches_path``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.transform import compose as jcompose
from mitsuba_tpu.core.transform import scale as jscale
from mitsuba_tpu.core.transform import translate as jtranslate
from mitsuba_tpu.models.bsdfs import DispersiveDielectric as JDispersive
from mitsuba_tpu.models.bsdfs import SmoothDielectric as JDielectric
from mitsuba_tpu.models.integrators import ParticleTracerIntegrator as JPT
from mitsuba_tpu.models.integrators import render as jrender
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.models.shapes import Mesh as JMesh
from mitsuba_tpu.models.shapes import cube as jcube
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
from mitsuba_tpu_torch import (ParticleTracerIntegrator, PathIntegrator,
                               cornell_box, render, scene_from_numpy)
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.models.bsdfs import DispersiveDielectric
from mitsuba_tpu_torch.models.film import Film, ReconstructionFilter, splat
from mitsuba_tpu_torch.models.integrators.ptracer import render_ptracer
from torch_parity import export_scene

SEED, SPP = 2, 16
CASES = {"cornell": (4, False), "glass": (6, False), "dispersive": (6, True)}


def _jax_scene(case):
    """The JAX Cornell box at 8x8; with a glass slab (``glass``) or a
    dispersive one (``dispersive``) between the light and the boxes.  The
    slab floats: where two faces are coplanar (the boxes' bottoms and the
    floor) a hit is a tie that either package may break its own way."""
    scene = jcornell_box(width=8, height=8)
    if case == "cornell":
        return scene
    glass = (JDielectric(eta=jnp.asarray(1.5)) if case == "glass"
             else JDispersive(int_ior_d=jnp.asarray(1.6),
                              int_V_d=jnp.asarray(20.0),
                              ext_ior_d=jnp.asarray(1.0),
                              ext_V_d=jnp.asarray(0.0)))
    v, f, _, _ = jcube(jcompose(jtranslate([0.1, 0.5, 0.1]),
                                jscale([0.45, 0.06, 0.45])))
    slab = JMesh.make(v, f, bsdf_index=len(scene.bsdfs), id="slab")
    return jmake_scene(list(scene.meshes) + [slab],
                       list(scene.bsdfs) + [glass], list(scene.emitters),
                       scene.sensor, use_bvh=False)


@pytest.fixture(scope="module")
def jax_images():
    """{case: (JAX image, the port's scene of the same arrays)}, the JAX
    images of all cases from one jitted program."""
    scenes = {c: _jax_scene(c) for c in CASES}

    @jax.jit
    def images(scs):
        return {c: jrender(sc, JPT(max_depth=CASES[c][0], rr_depth=3,
                                   spectral=CASES[c][1]), seed=SEED, spp=SPP)
                for c, sc in scs.items()}

    out = images(scenes)
    return {c: (np.asarray(out[c]),
                scene_from_numpy(export_scene(scenes[c]), device="cpu"))
            for c in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_ptracer_image_matches_jax(jax_images, case):
    want, scene = jax_images[case]
    depth, spectral = CASES[case]
    got = render(scene, ParticleTracerIntegrator(max_depth=depth, rr_depth=3,
                                                 spectral=spectral),
                 SEED, SPP, device="cpu").numpy()
    assert got.shape == want.shape == (8, 8, 3)
    assert np.isfinite(got).all() and want.mean() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dispersion_moves_the_image(jax_images):
    """The spectral glass box renders otherwise than the RGB one: the
    hero wavelengths reach the dispersive BSDF."""
    _, scene = jax_images["dispersive"]
    rgb = render(scene, ParticleTracerIntegrator(6, 3, spectral=False), SEED,
                 SPP, device="cpu")
    spec = render(scene, ParticleTracerIntegrator(6, 3, spectral=True), SEED,
                  SPP, device="cpu")
    assert not torch.allclose(rgb, spec, rtol=1e-3)


def test_wavelengths_reach_the_dispersive_bsdf():
    """A ray's wavelengths ride the interaction it makes and the rays it
    spawns, and the dispersive glass's IOR follows them (n(450 nm) >
    n_d > n(650 nm)); without them it takes 589.3 nm, n_d itself."""
    scene = cornell_box(8, 8, device="cpu")
    n = 4
    o = torch.tensor([[0.0, 0.0, 3.0]]).expand(n, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    lam = torch.tensor([[450.0], [500.0], [589.3], [650.0]])
    ray = Ray(o=o, d=d, maxt=torch.full((n,), float("inf")), wavelengths=lam)
    ctx = scene.trace_ctx()
    si = scene.ray_intersect(ray, torch.ones(n, dtype=torch.bool), ctx)
    assert torch.equal(si.wavelengths, lam)
    assert torch.equal(si.spawn_ray(si.n).wavelengths, lam)
    glass = DispersiveDielectric(*(torch.tensor(x) for x in (1.6, 20.0, 1.0,
                                                             0.0)))
    eta = glass._eta(si)
    assert eta[0] > eta[1] > eta[3]
    assert abs(float(eta[2]) - 1.6) < 1e-6
    plain = dataclasses.replace(si, wavelengths=None)
    assert torch.allclose(glass._eta(plain), torch.tensor(1.6))


def test_spectral_flux_matches_rgb():
    """The spectral estimator's expectation is the RGB one's on a scene
    without dispersion (the flat response integrates to 1 a channel):
    the image means agree within the noise of 16x16 x 64 paths."""
    scene = cornell_box(16, 16, device="cpu")
    rgb = render(scene, ParticleTracerIntegrator(3, 16), 0, 64, device="cpu")
    spec = render(scene, ParticleTracerIntegrator(3, 16, spectral=True), 0, 64,
                  device="cpu")
    assert abs(float(spec.mean()) / float(rgb.mean()) - 1.0) < 0.05


def test_ptracer_matches_path():
    """Light tracing and path tracing estimate the same image, by the bars
    of tests/test_ptracer.py ``test_ptracer_matches_path`` (the flux within
    3 %, each channel of the interior within 6 %) at half its 384 paths a
    pixel (seeds 0-7 measured within 1.7 % and 1.6 %)."""
    scene = cornell_box(24, 24, device="cpu")
    p = render(scene, PathIntegrator(max_depth=3, rr_depth=16), 0, 192,
               device="cpu").numpy()
    t = render_ptracer(scene, ParticleTracerIntegrator(max_depth=3,
                                                       rr_depth=16),
                       0, 192).numpy()
    assert abs(t.mean() / p.mean() - 1.0) < 0.03, (p.mean(), t.mean())
    a, b = p[5:19, 5:19].mean((0, 1)), t[5:19, 5:19].mean((0, 1))
    assert np.all(np.abs(a - b) / a < 0.06), (a, b)


def test_splat_normalizes_and_differentiates():
    """``splat`` with the tent filter: each sample's weights sum to 1,
    the weight channel counts the active samples,
    and the splat is differentiable in the positions."""
    pos = torch.tensor([[1.3, 2.7], [5.5, 0.5], [7.9, 7.9]],
                       requires_grad=True)
    val = torch.ones((3, 3))
    img = splat(pos, val, 8, 8, ReconstructionFilter.tent(),
                active=torch.tensor([True, True, False]))
    assert img.shape == (8, 8, 4)
    assert torch.allclose(img[..., 3].sum(), torch.tensor(2.0))
    assert torch.allclose(img[..., :3].sum(), torch.tensor(6.0))
    w = torch.arange(64.0).reshape(8, 8, 1)
    (g,) = torch.autograd.grad((img[..., :1] * w).sum(), pos)
    assert torch.isfinite(g).all() and g[0].abs().sum() > 0
    assert torch.equal(g[2], torch.zeros(2))
    assert Film(8, 8, ReconstructionFilter.tent()).put(
        pos.detach(), val).shape == (8, 8, 4)
