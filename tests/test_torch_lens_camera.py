"""The port's realistic-lens camera against mitsuba_tpu, on the CPU.

The JAX references are built once, in module fixtures: three cameras on
the Cornell box's pose at 16 x 16 (the singlet sampling its rear
element, the double Gauss with its exit-pupil table at 16 segments of
4096 rays, the spectral doublet), each carried to the port by
``convert.lens_camera_from_numpy`` so that both packages trace the same
interfaces.  A float32 trace through up to 11 interfaces rounds a little
differently in XLA and in PyTorch, so a lane that grazes a rim or the
stop may live in one and die in the other: the bars hold the lanes alive
in both per lane and the flipped lanes to a stated share (none flipped
when this file was written).  The tests at the end mirror
tests/test_lens.py on the port alone.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import qmc as jqmc
from mitsuba_tpu.core.records import Ray as JRay
from mitsuba_tpu.lens import focus_thick_lens as jfocus
from mitsuba_tpu.lens import make_lens_camera as jmake_lens_camera
from mitsuba_tpu.lens import thick_lens_approximation as jthick
from mitsuba_tpu.lens.designs import build_design as jbuild_design
from mitsuba_tpu.lens.materials import DispersiveMaterial as JMaterial
from mitsuba_tpu.models.film import Film as JFilm
from mitsuba_tpu.models.integrators import PathIntegrator as JPath
from mitsuba_tpu.models.integrators.common import sample_rays as jsample_rays
from mitsuba_tpu.utils.params import traverse as jtraverse
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                               PRBIntegrator, cornell_box, prb_render,
                               render, sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.core import qmc
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.lens import (DispersiveMaterial, build_design,
                                    compute_exit_pupil_lut, focus_thick_lens,
                                    make_lens_camera,
                                    thick_lens_approximation)
from mitsuba_tpu_torch.lens.designs import DESIGNS
from mitsuba_tpu_torch.models.bsdfs import SmoothDiffuse
from mitsuba_tpu_torch.models.emitters import AreaEmitter
from mitsuba_tpu_torch.models.film import Film, ReconstructionFilter
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.sensors import PerspectiveCamera
from mitsuba_tpu_torch.models.shapes import Mesh, rectangle
from mitsuba_tpu_torch.models.textures import BitmapTexture, ConstantTexture
from mitsuba_tpu_torch.utils.params import traverse, update
from torch_parity import export_interfaces, export_scene

SEED, SPP, SIZE = 3, 2, 16
RTOL, ATOL = 1e-5, 1e-6
# the share of lanes whose alive flag may differ between the packages
FLIP_SHARE = 0.01
CAMERAS = {"singlet": {}, "doublet": dict(spectral=True),
           "gauss": dict(sample_exit_pupil=True, pupil_segments=16,
                         pupil_rays_per_segment=4096)}
# (design, interface index): the doublet's plane, sphere and stop, the
# double Gauss's stop and a sphere, two aspheres of the all-aspheric lens
ELEMENTS = [("doublet", 0), ("doublet", 1), ("doublet", 3), ("gauss", 5),
            ("gauss", 7), ("asph", 0), ("asph", 4)]
N_ELEM = 512


def _with_db(cam, db, vec):
    """The camera (of either package) with ``db`` added to the Cauchy B of
    every glass side; ``vec`` makes the package's (2,) array."""
    def glass(g):
        return dataclasses.replace(g, cauchy=g.cauchy + vec([0.0, 1.0]) * db
                                   * (g.cauchy[0] > 1.01))

    return dataclasses.replace(cam, interfaces=tuple(
        dataclasses.replace(it, left=glass(it.left), right=glass(it.right))
        for it in cam.interfaces))


def _linear_coeffs():
    """Seeded coefficients of the scalar whose Cauchy-B gradient is held."""
    rng = np.random.default_rng(7)
    return {k: rng.normal(size=(SIZE * SIZE * SPP, 3)).astype(np.float32)
            for k in ("o", "d", "w")}


def _direction_inputs():
    rng = np.random.default_rng(5)
    return (rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32),
            rng.uniform(size=(512, 2)).astype(np.float32))


def _element_rays(el, index):
    """Seeded rays from an element's film side toward it (spectral on odd
    indices), 5 % of them inactive: (o, d, wavelengths or None, active)."""
    r, z = float(el.element_radius), float(el.z_intercept)
    rng = np.random.default_rng(index)
    n = N_ELEM
    o = np.stack([rng.uniform(-r, r, n), rng.uniform(-r, r, n),
                  np.full(n, z - r)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-1.2 * r, 1.2 * r, n),
                    rng.uniform(-1.2 * r, 1.2 * r, n), np.full(n, z)], -1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    lam = (rng.uniform(400.0, 700.0, (n, 1)).astype(np.float32)
           if index % 2 else None)
    return o, d.astype(np.float32), lam, rng.uniform(size=n) < 0.95


def _compiled(fn, *args):
    """``fn(*args)`` jitted, compiled at XLA's backend optimisation level
    0, which compiles faster than the default level; the same checks
    pass at either (each level, like eager JAX, rounds a few lanes' last
    bits its own way)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_lanes(cams, base):
    """The per-lane JAX references of this file: each camera's
    sample_rays at 16 x 16 x 2, the singlet's connection to the sensor,
    and the Cornell box's PathIntegrator(3) lanes through the singlet at
    8 x 8 x 4 (L x weight)."""
    rays = {k: jsample_rays(types.SimpleNamespace(sensor=c), SEED, SPP)
            for k, c in cams.items()}
    ref, s2 = _direction_inputs()
    direction = cams["singlet"].sample_direction(jnp.asarray(ref),
                                                 jnp.asarray(s2))
    small = base.replace(sensor=cams["singlet"].replace(
        film=JFilm(width=8, height=8)))
    ray, w, _, lane = jsample_rays(small, SEED, 4)
    lanes = JPath(max_depth=3).sample(small, ray, lane, SEED,
                                      jnp.ones(lane.shape, bool)) * w
    return rays, direction, lanes


def _jax_grad(cam):
    """jax.grad of the seeded linear function of the spectral doublet's
    sample_rays with respect to a shift of every glass's Cauchy B."""
    c = _linear_coeffs()

    def loss(db):
        ray, w, _, _ = jsample_rays(types.SimpleNamespace(
            sensor=_with_db(cam, db, jnp.asarray)), SEED, SPP)
        return (jnp.sum(ray.o * c["o"]) + jnp.sum(ray.d * c["d"])
                + jnp.sum(w * c["w"]))

    return jax.grad(loss)(jnp.float32(0.0))


def _jax_elements(elements, rays):
    return [el.compute_interaction(ray, active)
            for el, (ray, active) in zip(elements, rays)]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX cameras on the Cornell box's pose, focused at 3.9, each
    with the port's scene of the same arrays (``scenes``), and the JAX
    references computed from them."""
    base = jcornell_box(width=8, height=8)
    cams = {name: jmake_lens_camera(name, film=JFilm(width=SIZE, height=SIZE),
                                    to_world=base.sensor.to_world,
                                    focus_distance=3.9, **kw)
            for name, kw in CAMERAS.items()}
    scenes = {name: scene_from_numpy(export_scene(base.replace(sensor=cam)),
                                     device="cpu")
              for name, cam in cams.items()}
    rays, direction, lanes = _compiled(_jax_lanes, cams, base)
    return dict(cams=cams, scenes=scenes, rays=rays, direction=direction,
                lanes=np.array(lanes),
                grad=float(_compiled(_jax_grad, cams["doublet"])))


@pytest.fixture(scope="module")
def jax_elements():
    """{(design, index): (the JAX and the port's element, its rays, JAX's
    (ray out, valid))}, every element through one compile."""
    els, rays = {}, []
    for design, index in ELEMENTS:
        jel = jbuild_design(design)[0][index]
        els[design, index] = (jel, build_design(design, device="cpu")[0][index],
                              _element_rays(jel, index))
        o, d, lam, active = els[design, index][2]
        rays.append((_jray(o, d, lam), jnp.asarray(active)))
    outs = _compiled(_jax_elements, [e[0] for e in els.values()], rays)
    return {k: (*v, out) for (k, v), out in zip(els.items(), outs)}


def _jray(o, d, wavelengths=None):
    n = o.shape[0]
    return JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.full((n,), np.inf),
                time=jnp.zeros((n,)),
                wavelengths=(jnp.zeros((n, 0)) if wavelengths is None
                             else jnp.asarray(wavelengths)))


def _ray(o, d, wavelengths=None):
    return Ray(o=torch.as_tensor(o), d=torch.as_tensor(d),
               maxt=torch.full((o.shape[0],), float("inf")),
               wavelengths=(None if wavelengths is None
                            else torch.as_tensor(wavelengths)))


def _assert_lanes(jalive, alive, pairs, rtol=RTOL, atol=ATOL):
    """The alive masks agree but for FLIP_SHARE of the lanes; each (JAX,
    port) pair of arrays agrees per lane where both are alive."""
    jalive, alive = np.asarray(jalive), np.asarray(alive)
    flips = int((jalive != alive).sum())
    assert flips <= FLIP_SHARE * jalive.size, flips
    both = jalive & alive
    assert both.sum() > 0
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(np.asarray(b)[both], np.asarray(a)[both],
                                   rtol=rtol, atol=atol, err_msg=name)
    return flips


# ------------------------------------------------------------------ core

@pytest.mark.parametrize("base", [2, 3, 5])
def test_qmc_bit_equal(base):
    """Indices up to 2^20 (every 61st) and just below 2^31 (and, in base
    2, 2^32), against eager JAX (what the exit-pupil table draws)."""
    i = np.concatenate([np.arange(0, 1 << 20, 61),
                        np.arange((1 << 31) - 4096, 1 << 31)])
    if base == 2:
        i = np.concatenate([i, np.arange((1 << 32) - 4096, 1 << 32)])
        want = jqmc.radical_inverse_2(jnp.asarray(i, jnp.uint32))
    else:
        want = jqmc.radical_inverse(base, jnp.asarray(i, jnp.int32))
    got = qmc.radical_inverse(base, torch.as_tensor(i)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    if base == 3:
        h = qmc.halton_2d(torch.as_tensor(i[:4096])).numpy()
        np.testing.assert_array_equal(h, np.asarray(jqmc.halton_2d(
            jnp.asarray(i[:4096], jnp.int32))))


def test_dispersive_ior():
    lam = np.linspace(0.38, 0.78, 64, dtype=np.float32)
    for make, jmake, args in (
            (DispersiveMaterial.cauchy_material,
             JMaterial.cauchy_material, ("glass", 1.64855, 0.0074490)),
            (DispersiveMaterial.sellmeier_material,
             JMaterial.sellmeier_material,
             ("NLAK9", [1.462319050, 0.344399589, 1.155083720],
              [0.007242702, 0.0243353131, 85.46868680]))):
        got, want = make(*args, device="cpu"), jmake(*args)
        zeros = np.zeros((2, 3), np.float32)
        jv = jax.jit(lambda m: (m.ior(jnp.asarray(lam)), m.abbe_number(),
                                m.ior_from_ray(_jray(zeros, zeros))))(want)
        np.testing.assert_allclose(got.ior(torch.as_tensor(lam)).numpy(),
                                   np.asarray(jv[0]), rtol=1e-6)
        np.testing.assert_allclose(float(got.abbe_number()), float(jv[1]),
                                   rtol=1e-6)
        # an RGB ray takes the d-line
        np.testing.assert_allclose(got.ior_from_ray(_ray(zeros, zeros))
                                   .numpy(), np.asarray(jv[2]), rtol=1e-6)


# ------------------------------------------------------------ the lenses

@pytest.mark.parametrize("design,index", ELEMENTS)
def test_element_interaction(design, index, jax_elements):
    """One interface's compute_interaction on seeded rays from its film
    side, against JAX's: the rays out per lane and valid."""
    _, el, (o, d, lam, active), (jout, jok) = jax_elements[design, index]
    out, ok = el.compute_interaction(_ray(o, d, lam), torch.as_tensor(active))
    assert np.asarray(jok).mean() > 0.1
    _assert_lanes(jok, ok.numpy(), {"o": (jout.o, out.o.numpy()),
                                    "d": (jout.d, out.d.numpy())})


@pytest.mark.parametrize("name", DESIGNS)
def test_design_matches_jax(name):
    """build_design: the same interface kinds, glasses and parameters."""
    jifaces, jfilm_z, jfocus_on = jbuild_design(name)
    ifaces, film_z, focus_on = build_design(name, device="cpu")
    assert (film_z, focus_on) == (jfilm_z, jfocus_on)
    want = export_interfaces(jifaces)
    assert [e.kind for e in ifaces] == [e["kind"] for e in want]
    for e, w in zip(ifaces, want):
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(getattr(e, k).numpy(), v,
                                           rtol=1e-7, atol=1e-7, err_msg=k)
        for side in ("left", "right"):
            g = getattr(e, side)
            assert (g.name, g.use_cauchy) == (w[side]["name"],
                                              w[side]["use_cauchy"])
            np.testing.assert_array_equal(g.cauchy.numpy(),
                                          w[side]["cauchy"])
            np.testing.assert_array_equal(g.sellmeier_C.numpy(),
                                          w[side]["sellmeier_C"])
    # every interface has glass tensors of its own
    tensors = [id(getattr(e, s).cauchy) for e in ifaces
               for s in ("left", "right")]
    assert len(set(tensors)) == len(tensors)


def test_make_lens_camera_builds_every_design():
    """make_lens_camera builds, focuses and traces each of the 15 designs
    on the CPU when asked, and without a GPU raises when not asked."""
    for name in DESIGNS:
        cam = make_lens_camera(name, film=Film(8, 8), device="cpu")
        assert cam.device.type == "cpu" and len(cam.interfaces) >= 2
        z = [float(e.z_intercept) for e in cam.interfaces]
        assert all(np.isfinite(z)) and z == sorted(z), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_lens_camera("singlet")


@pytest.mark.parametrize("name", list(CAMERAS))
def test_thick_lens_and_focus(name, jax_refs):
    jcam = jax_refs["cams"][name]
    cam = jax_refs["scenes"][name].sensor
    want, got = jthick(jcam), thick_lens_approximation(cam)
    assert got[4] and want[4]
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-5)
    np.testing.assert_allclose(focus_thick_lens(cam, 6.0),
                               jfocus(jcam, 6.0), rtol=1e-5, atol=1e-9)
    # the port's own build: autofocus to 3.9 lands on JAX's interfaces
    own = make_lens_camera(name, film=Film(SIZE, SIZE),
                           to_world=np.array(jcam.to_world),
                           focus_distance=3.9, device="cpu",
                           spectral=jcam.spectral)
    for e, je in zip(own.interfaces, jcam.interfaces):
        np.testing.assert_allclose(float(e.z_intercept),
                                   float(je.z_intercept), rtol=1e-6)


def test_loader_hook_matches_jax():
    """make_realistic_lens_camera, the scene loader's hook, builds the
    JAX package's camera from the same sensor dict."""
    from mitsuba_tpu.lens.camera import make_realistic_lens_camera as jhook
    from mitsuba_tpu_torch.lens import make_realistic_lens_camera

    d = {"lens_design": "doublet", "diagonal_mm": 24.0,
         "object_distance": 3.0, "lens_focal_length": 0.06,
         "to_world": np.eye(4), "spectral": True}
    want = jhook(d, JFilm(width=8, height=8), None)
    got = make_realistic_lens_camera(d, Film(8, 8), None, device="cpu")
    assert (got.diagonal, got.spectral) == (want.diagonal, want.spectral)
    for e, w in zip(got.interfaces, export_interfaces(want.interfaces)):
        assert e.kind == w["kind"]
        np.testing.assert_allclose(e.z_intercept.numpy(), w["z_intercept"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(e.element_radius.numpy(),
                                      w["element_radius"])


def test_exit_pupil_lut(jax_refs):
    """The double Gauss's table at 16 x 4096 rays: each box within the
    rays' spacing of JAX's (equal unless a grazing ray's alive flag
    flips)."""
    jcam = jax_refs["cams"]["gauss"]
    cam = jax_refs["scenes"]["gauss"].sensor
    mn, mx = compute_exit_pupil_lut(cam, 16, 4096)
    spacing = 4.0 * 1.5 * float(cam.rear_radius) * np.sqrt(2.0 / 4096)
    for got, want in ((mn, jcam.pupil_min), (mx, jcam.pupil_max)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert err.max() <= spacing, err.max()
        assert (err == 0).mean() >= 0.9
    assert (mx > mn).all()


# ------------------------------------------------------ the camera's rays

@pytest.mark.parametrize("name", list(CAMERAS))
def test_sample_rays_match_jax(name, jax_refs):
    """sample_rays per lane: ray origin, direction, maxt, wavelengths and
    weight (0 on a vignetted lane), 16 x 16 x 2 spp.  The spectral
    camera's weight takes rtol 1e-4: its RGB response and pdf (float32
    exp, cosh, atanh) round differently in XLA and PyTorch."""
    scene = jax_refs["scenes"][name]
    jray, jw, _, jlane = jax_refs["rays"][name]
    ray, w, _, lane = sample_rays(scene, SEED, SPP)
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jlane))
    jalive = np.asarray(jw).max(-1) > 0
    alive = w.numpy().max(-1) > 0
    pairs = {"o": (jray.o, ray.o.numpy()), "d": (jray.d, ray.d.numpy()),
             "maxt": (jray.maxt, ray.maxt.numpy())}
    if scene.sensor.spectral:
        pairs["wavelengths"] = (jray.wavelengths, ray.wavelengths.numpy())
        _assert_lanes(jalive, alive, {"weight": (jw, w.numpy())}, rtol=1e-4)
    else:
        assert ray.wavelengths is None
        pairs["weight"] = (jw, w.numpy())
    _assert_lanes(jalive, alive, pairs)
    assert 0.3 < alive.mean() and (w.numpy()[~alive] == 0).all()


def test_sample_direction_matches_jax(jax_refs):
    """The connection to the sensor from seeded points of the box; the
    film position in units of the film (uv / (W, H)), where an ulp of the
    film point near the film's edge is ~1e-7."""
    jds, jimp = jax_refs["direction"]
    ref, s2 = _direction_inputs()
    ds, imp = jax_refs["scenes"]["singlet"].sensor.sample_direction(
        torch.as_tensor(ref), torch.as_tensor(s2))
    jok, ok = np.asarray(jds.pdf) > 0, ds.pdf.numpy() > 0
    assert jok.mean() > 0.05
    _assert_lanes(jok, ok, {k: (getattr(jds, k), getattr(ds, k).numpy())
                            for k in ("p", "n", "d", "dist", "pdf")}
                  | {"importance": (jimp, imp.numpy()),
                     "uv / size": (np.asarray(jds.uv) / SIZE,
                                   ds.uv.numpy() / SIZE)})


def test_particle_tracer_connects_through_the_lens(jax_refs):
    """The particle tracer's connection to the sensor takes the lens
    camera as it takes the pinhole: the Cornell box through the singlet
    is lit and finite."""
    from mitsuba_tpu_torch import ParticleTracerIntegrator

    scene = jax_refs["scenes"]["singlet"]
    img = render(scene, ParticleTracerIntegrator(4, 3), seed=SEED, spp=4,
                 device="cpu")
    assert img.shape == (SIZE, SIZE, 3) and torch.isfinite(img).all()
    assert float(img.mean()) > 0.0


def test_traverse_paths_match_jax(jax_refs):
    """The camera's parameter paths and values are the JAX package's,
    one leaf a path."""
    jp = {f"sensor.{k}": np.asarray(v)
          for k, v in jtraverse(jax_refs["cams"]["gauss"]).items()}
    p = traverse(jax_refs["scenes"]["gauss"], "^sensor\\.")
    assert list(p) == list(jp)
    for k, v in p.items():
        np.testing.assert_array_equal(v.numpy(), jp[k])
    assert "sensor.interfaces.0.right.cauchy" in p
    assert len({id(v) for v in p.values()}) == len(p)


def test_cauchy_b_gradient_of_rays(jax_refs):
    """d/dB of a seeded linear function of sample_rays' output through the
    spectral doublet, against jax.grad (1e-3 relative)."""
    scene = jax_refs["scenes"]["doublet"]
    db = torch.zeros((), requires_grad=True)
    sc = dataclasses.replace(scene, sensor=_with_db(scene.sensor, db,
                                                    torch.tensor))
    ray, w, _, _ = sample_rays(sc, SEED, SPP)
    c = {k: torch.as_tensor(v) for k, v in _linear_coeffs().items()}
    loss = (torch.sum(ray.o * c["o"]) + torch.sum(ray.d * c["d"])
            + torch.sum(w * c["w"]))
    loss.backward()
    want = jax_refs["grad"]
    assert np.isfinite(want) and want != 0.0
    np.testing.assert_allclose(float(db.grad), want, rtol=1e-3)


# ----------------------------------------------------- the slice, whole

def test_lens_render_matches_jax(jax_refs):
    """The Cornell box through the singlet at 8 x 8 x 4, depth 3: the JAX
    PathIntegrator's per-lane film contribution (L x weight) against
    the port's wavefront PathIntegrator and its MegakernelPathIntegrator
    (the plain brute route on the CPU): 99.5 % of lanes within 2e-3 and
    the mean within 2e-3 (tests/test_megakernel.py's bar)."""
    want = torch.as_tensor(jax_refs["lanes"])
    scene = jax_refs["scenes"]["singlet"]
    scene = dataclasses.replace(scene, sensor=dataclasses.replace(
        scene.sensor, film=Film(8, 8)))
    ray, w, _, lane = sample_rays(scene, SEED, 4)
    active = torch.ones(lane.shape, dtype=torch.bool)
    for integ in (PathIntegrator(max_depth=3),
                  MegakernelPathIntegrator(max_depth=3, strict=True)):
        got = integ.sample(scene, ray, lane, SEED, active) * w
        assert torch.isfinite(got).all()
        close = torch.isclose(got, want, rtol=2e-3, atol=2e-3).all(-1)
        assert close.float().mean() >= 0.995, type(integ).__name__
        assert abs(float(got.mean() - want.mean())) <= 2e-3 * float(
            want.mean())


# ---------------------------------- tests/test_lens.py on the port alone

@pytest.fixture(scope="module")
def singlet():
    return make_lens_camera("singlet", film=Film(32, 32), focus_distance=6.0,
                            device="cpu")


def _film_trace(cam, o, d, wl=None):
    n = o.shape[0]
    lam = None if wl is None else torch.full((n, 1), wl)
    return cam.trace_ray_from_world(_ray(o, d, lam))


def _film_points(out, ok):
    t = -out.o[:, 2] / out.d[:, 2]
    return (out.o + out.d * t[:, None])[ok].numpy()


def test_thick_lens_focal_length(singlet):
    """Biconvex singlet, R = 50 mm, n(589 nm) = 1.5046 + 0.021 / 0.589^2:
    the thin lens's f = 44.2 mm, the thick lens's slightly less."""
    _, f_img, _, f_obj, ok = thick_lens_approximation(singlet)
    assert ok and abs(f_img - 0.0444) < 0.002 and abs(f_img - f_obj) < 1e-4


def test_trace_reciprocity(singlet):
    """backward(forward(ray)) == ray (realisticlens.cpp:1987-2024)."""
    rng = np.random.default_rng(0)
    n = 512
    o = np.stack([rng.uniform(-0.01, 0.01, n), rng.uniform(-0.01, 0.01, n),
                  np.zeros(n)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-0.004, 0.004, n),
                    rng.uniform(-0.004, 0.004, n),
                    np.full(n, float(singlet.rear_z))], -1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    out, active = singlet.trace_ray_from_film(_ray(o, d.astype(np.float32)))
    assert int(active.sum()) > n // 2
    back, ok2 = singlet.trace_ray_from_world(
        Ray(o=out.o, d=-out.d, maxt=out.maxt), active)
    m = (active & ok2).numpy()
    err = np.linalg.norm(_film_points(back, active & ok2) - o[m], axis=-1)
    assert err.max() < 1e-6, err.max()


def test_object_point_images_to_film_point(singlet):
    """Rays from the 6 m focus point converge to a small on-axis spot."""
    rng = np.random.default_rng(1)
    n = 400
    front_z = float(singlet.interfaces[-1].z_intercept)
    ap = np.stack([rng.uniform(-0.004, 0.004, n),
                   rng.uniform(-0.004, 0.004, n), np.full(n, front_z)], -1)
    obj = np.array([0, 0, 6.0])
    d = ((ap - obj) / np.linalg.norm(ap - obj, axis=-1, keepdims=True))
    out, ok = _film_trace(singlet, np.tile(obj, (n, 1)).astype(np.float32),
                          d.astype(np.float32))
    pf = _film_points(out, ok)
    assert len(pf) > 100
    assert np.sqrt((np.linalg.norm(pf[:, :2], axis=-1) ** 2).mean()) < 1e-4


def test_chromatic_dispersion():
    """The spot at the d-line focus grows away from 589 nm."""
    cam = make_lens_camera("singlet", film=Film(32, 32), spectral=True,
                           focus_distance=6.0, device="cpu")
    rng = np.random.default_rng(2)
    n = 200
    front_z = float(cam.interfaces[-1].z_intercept)
    ap = np.stack([rng.uniform(-0.003, 0.003, n), np.zeros(n),
                   np.full(n, front_z)], -1)
    obj = np.array([0, 0, 6.0])
    d = ((ap - obj) / np.linalg.norm(ap - obj, axis=-1, keepdims=True))
    o = np.tile(obj, (n, 1)).astype(np.float32)

    def spot(wl):
        pf = _film_points(*_film_trace(cam, o, d.astype(np.float32), wl))
        return np.sqrt((np.linalg.norm(pf[:, :2] - pf[:, :2].mean(0),
                                       axis=-1) ** 2).mean())

    s_blue, s_d, s_red = spot(450.0), spot(589.3), spot(656.0)
    assert s_d < 2e-5 and s_blue > 3 * s_d and s_red > 1.5 * s_d


def test_aperture_stop_vignettes():
    """The doublet's stop kills a ray aimed outside its radius."""
    cam = make_lens_camera("doublet", film=Film(16, 16), focus_distance=6.0,
                           device="cpu")
    assert cam.interfaces[-1].kind == "aperture"
    d = np.asarray([[-0.5, 0.0, 1.0]], np.float32)
    _, ok = cam.trace_ray_from_film(_ray(
        np.asarray([[0.012, 0.0, 0.0]], np.float32),
        d / np.linalg.norm(d)))
    assert not bool(ok[0])


def test_asph_lens_traces():
    """The all-aspheric design's Newton intersection transmits near-axial
    rays, with finite directions and no graph in its detached steps."""
    cam = make_lens_camera("asph", film=Film(8, 8), device="cpu")
    rng = np.random.default_rng(3)
    n = 256
    o = np.stack([rng.uniform(-2e-4, 2e-4, n), rng.uniform(-2e-4, 2e-4, n),
                  np.zeros(n)], -1).astype(np.float32)
    ang = rng.uniform(-0.05, 0.05, (n, 2))
    d = np.stack([ang[:, 0], ang[:, 1], np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    out, ok = cam.trace_ray_from_film(_ray(o, d))
    assert int(ok.sum()) > n // 2
    assert torch.isfinite(out.d[ok]).all()
    # gradients reach c, K and the ai through the one attached step
    el = cam.interfaces[2]
    leaves = {k: getattr(el, k).clone().requires_grad_()
              for k in ("c_unitless", "kappa", "ai")}
    t = dataclasses.replace(el, **leaves).intersect(_ray(o, d))[0]
    g = torch.autograd.grad(t[torch.isfinite(t)].sum(), list(leaves.values()))
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in g)


def test_lens_render_cornell_upright():
    """The Cornell box through the singlet: finite, lit and upright (the
    ceiling light's rows brighter than the floor's)."""
    scene = cornell_box(24, 24, rfilter=ReconstructionFilter.box(),
                        device="cpu")
    cam = make_lens_camera("singlet", film=scene.sensor.film,
                           to_world=scene.sensor.to_world,
                           focus_distance=3.9, device="cpu")
    img = render(dataclasses.replace(scene, sensor=cam),
                 PathIntegrator(max_depth=3), seed=0, spp=16, device="cpu")
    assert torch.isfinite(img).all() and img.mean() > 0.02
    assert img[2:8].mean() > img[16:22].mean()


def _emitter_plane_scene(size, scale=0.35, smooth=False):
    """One emitting rectangle before a black background, seen from z = 3
    (tests/test_lens.py ``_emitter_plane_scene``): constant radiance 5,
    or a smooth bitmap (``smooth``) so that a camera gradient is not
    bound by visibility."""
    v, f, _, uv = rectangle(tf.scale(scale))
    em = Mesh.make(v, f, uvs=uv, bsdf_index=0, emitter_index=0, id="panel",
                   device="cpu")
    if smooth:
        yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32),
                             indexing="ij")
        data = 1.0 + 4.0 * np.exp(-8.0 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2))
        radiance = BitmapTexture(data=torch.as_tensor(
            np.repeat(data[..., None], 3, -1), dtype=torch.float32))
    else:
        radiance = ConstantTexture(torch.tensor([5.0, 5.0, 5.0]))
    pose = tf.look_at([0, 0, 3.0], [0, 0, 0], [0, 1, 0])
    film = Film(size, size, rfilter=ReconstructionFilter.box())
    sensor = PerspectiveCamera(to_world=torch.as_tensor(pose), film=film,
                               fov=40.0)
    white = SmoothDiffuse(reflectance=ConstantTexture(
        torch.tensor([0.5, 0.5, 0.5])))
    return make_scene([em], [white], [AreaEmitter(radiance=radiance)],
                      sensor, "cpu")


def _lens_on(scene, design, **kw):
    s = scene.sensor
    return dataclasses.replace(scene, sensor=make_lens_camera(
        design, film=s.film, to_world=s.to_world, focus_distance=3.0,
        device="cpu", **kw))


def test_spectral_camera_fringing():
    """A white panel through the spectral doublet shows R / B fringing at
    its edges; through the RGB doublet the channels agree."""
    scene = _emitter_plane_scene(24)

    def fringe(spectral):
        img = render(_lens_on(scene, "doublet", spectral=spectral),
                     PathIntegrator(max_depth=2), seed=0, spp=64,
                     device="cpu")
        assert torch.isfinite(img).all() and img.mean() > 1e-3
        return float((img[..., 0] - img[..., 2]).abs().mean())

    f_rgb, f_spec = fringe(False), fringe(True)
    assert f_spec > 5.0 * max(f_rgb, 1e-6), (f_spec, f_rgb)


def test_prb_cauchy_b_gradient_fd():
    """d mean(img^2) / d(Cauchy B of every glass) through prb_render (the
    depth-0 rays regenerated from the attached camera, and its weight),
    against central differences (tests/test_lens.py's 15 %)."""
    scene = _lens_on(_emitter_plane_scene(12, scale=2.0, smooth=True),
                     "singlet", spectral=True)
    keys = [k for k, v in traverse(scene, r"\.cauchy$").items()
            if float(v[0]) > 1.01]
    assert len(keys) == 2   # the singlet's glass, seen from both surfaces
    integ = PRBIntegrator(max_depth=2)

    def loss(db, grad=False):
        leaves = {k: (traverse(scene)[k] + torch.tensor([0.0, db]))
                  .requires_grad_(grad) for k in keys}
        img = prb_render(update(scene, leaves), integ, 0, 16, device="cpu")
        return torch.mean(img * img), leaves

    value, leaves = loss(0.0, grad=True)
    value.backward()
    g = sum(float(v.grad[1]) for v in leaves.values())
    eps = 2e-4
    with torch.no_grad():
        fd = float(loss(eps)[0] - loss(-eps)[0]) / (2 * eps)
    assert np.isfinite(g) and abs(g - fd) < 0.15 * max(abs(fd), 1e-6), (g, fd)
