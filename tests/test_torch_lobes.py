"""BASELINE config 2 in the port against mitsuba_tpu, on the CPU: the
conductor and dielectric lobes (Fresnel, GGX, the four BSDFs), the lobe
bounce of the three path megakernels' plain versions, the wavefront
``PathIntegrator`` and the ``DirectIntegrator`` over them, and the
fallback of a BVH deeper than the BVH megakernels' walk.

The eager functions agree per value at rtol = atol = 1e-5.  Whole paths
share the (seed, lane, dim) stream, so per-lane radiance agrees to float
rounding except on the rare lane where rounding flips a russian-roulette
or visibility decision (the bar of tests/test_megakernel.py: 99.5 % of
lanes within 2e-3, the mean within 2e-3).
"""
import logging
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.core.fresnel as jfresnel
import mitsuba_tpu.models.bsdfs as jbsdfs
import mitsuba_tpu.models.microfacet as jmf
from mitsuba_tpu.models.integrators import DirectIntegrator as JDirect
from mitsuba_tpu.models.integrators import PathIntegrator as JPath
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.ops.pallas.megakernel import megakernel_trace as jtrace
from mitsuba_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
import mitsuba_tpu_torch.core.fresnel as fresnel
import mitsuba_tpu_torch.models.bsdfs as bsdfs
import mitsuba_tpu_torch.models.microfacet as mf
from mitsuba_tpu_torch import (DirectIntegrator, MegakernelPathIntegrator,
                               PathIntegrator, cornell_box, render,
                               sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.shapes import Mesh
from mitsuba_tpu_torch.ops import megakernel_bvh as mkb
from mitsuba_tpu_torch.ops.megakernel import (megakernel_trace, pack_scene,
                                              plugin_subset_ok, scene_btypes)
from torch_parity import export_scene, jax_scene_with_ball, nested_clusters

SEED, SPP = 5, 2
CU = jbsdfs.CONDUCTOR_IOR["Cu"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _assert_lanes_close(got, want):
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} lanes match"
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


# ---------------------------------------------------------- eager models

def _cosines(n, seed):
    """Signed cosines over [-1, 1] with both ends, 0, and grazing ones."""
    r = np.random.default_rng(seed)
    c = r.uniform(-1.0, 1.0, n)
    c[:8] = [-1.0, 1.0, 0.0, 1e-4, -1e-4, 0.05, -0.05, 0.999]
    return c.astype(np.float32)


def _directions(n, seed, upper=False):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:4] = [[0, 0, 1], [0.9999, 0, 0.01414], [0, -0.99995, 0.01], [0, 0, -1]]
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v.astype(np.float32)


@pytest.mark.parametrize("eta", [1.5, 1.0 / 1.5, 1.0])
def test_fresnel_matches_jax(eta):
    """fresnel_dielectric (total internal reflection inside a denser
    medium at grazing cosines), fresnel_conductor and refract."""
    c = _cosines(512, 1)
    got = fresnel.fresnel_dielectric(torch.tensor(c), torch.tensor(eta))
    want = jfresnel.fresnel_dielectric(jnp.asarray(c), jnp.float32(eta))
    if eta < 1.0:
        assert (_np(want[0]) == 1.0).sum() > 50   # total internal reflection
    for g, w in zip(got, want):
        _close(g, w)
    wi = _directions(512, 2)
    _close(fresnel.refract(torch.tensor(wi), got[1], got[3]),
           jfresnel.refract(jnp.asarray(wi), want[1], want[3]))
    _close(fresnel.fresnel_conductor(torch.tensor(c), torch.tensor(CU[0]),
                                     torch.tensor(CU[1])),
           jfresnel.fresnel_conductor(jnp.asarray(c), CU[0], CU[1]))


def test_microfacet_matches_jax():
    """GGX D, Lambda, G1, G2 on directions of both hemispheres (grazing
    ones included), and the VNDF sample and its pdf, anisotropic."""
    ax, ay = 0.2, 0.35
    wi, wo = _directions(1024, 3), _directions(1024, 4)
    m = _directions(1024, 5, upper=True)
    u = np.random.default_rng(6).random((1024, 2)).astype(np.float32)
    t, j = (lambda x: torch.tensor(x)), jnp.asarray
    _close(mf.ggx_D(t(m), ax, ay), jmf.ggx_D(j(m), ax, ay))
    _close(mf.ggx_lambda(t(wi), ax, ay), jmf.ggx_lambda(j(wi), ax, ay))
    _close(mf.smith_g1(t(wi), t(m), ax, ay), jmf.smith_g1(j(wi), j(m), ax, ay))
    _close(mf.smith_g2(t(wi), t(wo), t(m), ax, ay),
           jmf.smith_g2(j(wi), j(wo), j(m), ax, ay))
    wu = _directions(1024, 7, upper=True)
    got = mf.sample_vndf(t(wu), t(u), ax, ay)
    want = jmf.sample_vndf(j(wu), j(u), ax, ay)
    _close(got, want)
    _close(mf.vndf_pdf(t(wu), got, ax, ay), jmf.vndf_pdf(j(wu), want, ax, ay))


def _bsdf_pair(kind):
    """(JAX BSDF, the port's) of one kind, Cu for conductors, eta 1.5."""
    alpha = 0.25
    if kind == "conductor":
        return (jbsdfs.SmoothConductor(eta=CU[0], k=CU[1]),
                bsdfs.SmoothConductor(eta=torch.tensor(_np(CU[0])),
                                      k=torch.tensor(_np(CU[1]))))
    if kind == "roughconductor":
        return (jbsdfs.RoughConductor(eta=CU[0], k=CU[1],
                                      alpha=jnp.float32(alpha)),
                bsdfs.RoughConductor(eta=torch.tensor(_np(CU[0])),
                                     k=torch.tensor(_np(CU[1])),
                                     alpha=torch.tensor(alpha)))
    if kind == "dielectric":
        return (jbsdfs.SmoothDielectric(eta=jnp.float32(1.5)),
                bsdfs.SmoothDielectric(eta=torch.tensor(1.5)))
    return (jbsdfs.RoughDielectric(eta=jnp.float32(1.5),
                                   alpha=jnp.float32(alpha)),
            bsdfs.RoughDielectric(eta=torch.tensor(1.5),
                                  alpha=torch.tensor(alpha)))


@pytest.mark.parametrize("kind", ["conductor", "dielectric", "roughconductor",
                                  "roughdielectric"])
def test_bsdf_matches_jax(kind):
    """``sample`` (direction, pdf, eta, delta, lobe flags, weight) and
    ``eval_pdf`` per lane, with wi on both sides of the surface (the
    dielectrics' inside), at random lobe and direction samples."""
    jb, tb = _bsdf_pair(kind)
    n = 2048
    wi, wo = _directions(n, 8), _directions(n, 9)
    r = np.random.default_rng(10)
    s1 = r.random(n).astype(np.float32)
    s2 = r.random((n, 2)).astype(np.float32)
    active = r.random(n) < 0.9
    jsi = SimpleNamespace(wi=jnp.asarray(wi), uv=jnp.zeros((n, 2)))
    tsi = SimpleNamespace(wi=torch.tensor(wi), uv=torch.zeros(n, 2))
    jbs, jw = jb.sample(jsi, jnp.asarray(s1), jnp.asarray(s2),
                        jnp.asarray(active))
    tbs, tw = tb.sample(tsi, torch.tensor(s1), torch.tensor(s2),
                        torch.tensor(active))
    ok = _np(jbs.pdf) > 0
    assert ok.mean() > 0.3
    np.testing.assert_array_equal(tbs.pdf.numpy() > 0, ok)
    for field in ("wo", "pdf", "eta"):
        _close(getattr(tbs, field)[ok], _np(getattr(jbs, field))[ok])
    for field in ("delta", "sampled_type"):
        np.testing.assert_array_equal(getattr(tbs, field).numpy()[ok],
                                      _np(getattr(jbs, field))[ok])
    _close(tw, jw)
    tv, tp = tb.eval_pdf(tsi, torch.tensor(wo), torch.tensor(active))
    jv, jp = jb.eval_pdf(jsi, jnp.asarray(wo), jnp.asarray(active))
    _close(tv, jv)
    _close(tp, jp)
    if kind == "roughdielectric":   # both configurations are evaluated
        refr = (wi[:, 2] * wo[:, 2] < 0) & (_np(jp) > 0)
        assert refr.sum() > 100 and ((wi[:, 2] < 0) & refr).sum() > 50


# ---------------------------------------------------------- the config-2 Cornell

def _jax_lobe_cornell(width, height):
    """The JAX Cornell box with every ported lobe: small box GGX rough
    conductor, large box GGX rough dielectric, green wall smooth
    conductor, red wall smooth dielectric (Cu, eta 1.5, alpha 0.2)."""
    base = jcornell_box(width=width, height=height)
    extra = [jbsdfs.RoughConductor(eta=CU[0], k=CU[1],
                                   alpha=jnp.float32(0.2)),
             jbsdfs.RoughDielectric(eta=jnp.float32(1.5),
                                    alpha=jnp.float32(0.2)),
             jbsdfs.SmoothConductor(eta=CU[0], k=CU[1]),
             jbsdfs.SmoothDielectric(eta=jnp.float32(1.5))]
    meshes = list(base.meshes)
    for mesh, bsdf in ((6, 3), (7, 4), (4, 5), (5, 6)):
        meshes[mesh] = meshes[mesh].replace(bsdf_index=bsdf)
    return jmake_scene(meshes, list(base.bsdfs) + extra, list(base.emitters),
                       base.sensor, use_bvh=False)


def test_brute_plain_matches_jax_megakernel():
    """The brute kernel's plain version against the JAX megakernel_trace
    in interpret mode on the lobe Cornell box, 16x16 x 2 spp.  Depth 3
    with russian roulette from depth 2 keeps the interpret-mode trace of
    the unrolled bounces to one third of depth 6 (each lobe is hit at the
    first and second bounces, and refractions enter and leave the large
    box)."""
    seed, depth, rr = 3, 3, 2
    jscene = _jax_lobe_cornell(16, 16)
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(seed), SPP)
    active = np.ones(lane.shape, bool)
    jtris, jlight, F, L, _, _ = jpack_scene(jscene)
    want = _np(jtrace(jtris, jlight, lane, ray.o, ray.d, jnp.asarray(active),
                      jnp.uint32(seed), max_depth=depth, rr_depth=rr,
                      n_faces=F, n_lights=L, btypes=(0, 1, 2, 3, 4),
                      interpret=True))
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    tris, light, tF, tL, _, _ = pack_scene(scene)
    np.testing.assert_array_equal(tris.numpy(), _np(jtris)[:F])
    assert scene_btypes(scene) == (0, 1, 2, 3, 4)
    before = megakernel_trace.launches
    got = megakernel_trace(
        tris, light, torch.tensor(_np(lane)), torch.tensor(_np(ray.o)),
        torch.tensor(_np(ray.d)), torch.tensor(active), seed,
        max_depth=depth, rr_depth=rr, n_faces=tF, n_lights=tL,
        btypes=scene_btypes(scene)).numpy()
    assert megakernel_trace.launches == before   # the CPU runs no kernel
    _assert_lanes_close(got, want)


@pytest.fixture(scope="module")
def lobe_cornell():
    """The lobe Cornell box at 8x8 in both packages, and the port's
    primary rays (2 spp)."""
    jscene = _jax_lobe_cornell(8, 8)
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    ray, weight, film_pos, lane = sample_rays(scene, SEED, SPP)
    return jscene, scene, (ray, weight, film_pos, lane)


@pytest.mark.parametrize("integrator", ["path", "direct"])
def test_integrator_matches_jax(lobe_cornell, integrator):
    """The wavefront PathIntegrator (delta lobes in the emitter-hit MIS and
    NEE, eta^2 in russian roulette, two-sided dielectric hits) and the
    DirectIntegrator per lane against the JAX ones, and ``render``'s image
    against the film of the JAX lanes."""
    jscene, scene, (ray, weight, film_pos, lane) = lobe_cornell
    jinteg, integ = {"path": (JPath(max_depth=6, rr_depth=5),
                              PathIntegrator(max_depth=6, rr_depth=5)),
                     "direct": (JDirect(), DirectIntegrator())}[integrator]
    jray, _, _, jlane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    want = _np(jinteg.sample(jscene, jray, jlane, jnp.uint32(SEED),
                             jnp.ones(jlane.shape, bool)))
    active = torch.ones(lane.shape, dtype=torch.bool)
    got = integ.sample(scene, ray, lane, SEED, active).numpy()
    _assert_lanes_close(got, want)
    film = scene.sensor.film
    image = render(scene, integ, seed=SEED, spp=SPP, device="cpu")
    want_image = film.develop(film.put_grouped(
        film_pos, torch.tensor(want) * weight, SPP, active))
    rel = float((image - want_image).abs().mean() / want_image.mean())
    assert image.shape == (8, 8, 3) and rel < 2e-3, rel


def test_megapath_takes_lobe_scene(lobe_cornell):
    """MegakernelPathIntegrator(strict=True) takes the lobe scene on the
    brute branch and agrees per lane with the wavefront path."""
    _, scene, (ray, _, _, lane) = lobe_cornell
    active = torch.ones(lane.shape, dtype=torch.bool)
    got = MegakernelPathIntegrator(6, 5, strict=True).sample(
        scene, ray, lane, SEED, active)
    want = PathIntegrator(6, 5).sample(scene, ray, lane, SEED, active)
    _assert_lanes_close(got.numpy(), want.numpy())


# ---------------------------------------------------------- the BVH branch

@pytest.fixture(scope="module")
def rough_ball():
    """bvh_case's scene (Cornell box + sphere_mesh(3), 1,316 faces) with
    the ball a GGX rough dielectric (eta 1.5, alpha 0.2), the small box a
    smooth conductor, the green wall a GGX rough conductor and the red
    wall a smooth dielectric: the JAX wavefront's per-lane L (16x16 x 2
    spp, depth 6, rr 5) and the port's scene and rays."""
    base = jax_scene_with_ball(16, 16, 3, use_bvh=False)
    meshes = list(base.meshes)
    for mesh, bsdf in ((-1, 3), (6, 4), (4, 5), (5, 6)):
        meshes[mesh] = meshes[mesh].replace(bsdf_index=bsdf)
    jscene = jmake_scene(
        meshes, list(base.bsdfs) + [
            jbsdfs.RoughDielectric(eta=jnp.float32(1.5),
                                   alpha=jnp.float32(0.2)),
            jbsdfs.SmoothConductor(eta=CU[0], k=CU[1]),
            jbsdfs.RoughConductor(eta=CU[0], k=CU[1],
                                  alpha=jnp.float32(0.2)),
            jbsdfs.SmoothDielectric(eta=jnp.float32(1.5))],
        list(base.emitters), base.sensor, use_bvh=True)
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    want = _np(JPath(max_depth=6, rr_depth=5).sample(
        jscene, ray, lane, jnp.uint32(SEED), jnp.ones(lane.shape, bool)))
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    return want, scene, ray, lane, torch.ones(lane.shape, dtype=torch.bool)


def test_bvh_lobes_match_jax_wavefront(rough_ball):
    """The BVH kernels' plain versions, per-depth sorted (the bounce) and
    in one launch over Morton-ordered lanes, and the port's wavefront
    path, per lane against the JAX wavefront; sort on and off agree
    exactly."""
    want, scene, ray, lane, active = rough_ball
    assert scene.accel is not None and mkb.megakernel_bvh_applicable(scene)
    assert scene_btypes(scene) == (0, 1, 2, 3, 4)
    sorted_L = MegakernelPathIntegrator(6, 5, strict=True).sample(
        scene, ray, lane, SEED, active)
    single = MegakernelPathIntegrator(6, 5, sort_bounces=False).sample(
        scene, ray, lane, SEED, active)
    plain = mkb.megakernel_trace_bvh_plain(
        mkb.pack_scene_bvh(scene), lane, ray.o, ray.d, active, SEED, 6, 5,
        smooth=True, btypes=scene_btypes(scene))
    _assert_lanes_close(sorted_L.numpy(), want)
    for other in (single, plain):
        torch.testing.assert_close(other, sorted_L, rtol=0, atol=0)
    _assert_lanes_close(PathIntegrator(6, 5).sample(
        scene, ray, lane, SEED, active).numpy(), want)


# ---------------------------------------------------------- the stack-cap fallback

def test_deep_bvh_falls_back(caplog):
    """The Cornell box plus 1,000 triangles in nested clusters: a tree
    deeper than STACK_CAP leaves the BVH kernels.  The default integrator
    renders the wavefront's exact image, and says so in the log;
    strict=True raises; the wrappers still raise."""
    base = cornell_box(4, 4, device="cpu")
    v, f = nested_clusters()
    cluster = Mesh.make(v, f, bsdf_index=0, id="clusters", device="cpu")
    scene = make_scene(list(base.meshes) + [cluster], base.bsdfs,
                       base.emitters, base.sensor, "cpu")
    assert scene.accel.depth > mkb.STACK_CAP
    assert not mkb.megakernel_bvh_applicable(scene)
    with caplog.at_level(logging.INFO, "mitsuba_tpu_torch"):
        image = render(scene, MegakernelPathIntegrator(6, 5), seed=1, spp=2,
                       device="cpu")
    assert "deeper than the BVH megakernels' walk" in caplog.text
    assert torch.isfinite(image).all() and image.mean() > 0
    torch.testing.assert_close(image, render(
        scene, PathIntegrator(6, 5), seed=1, spp=2, device="cpu"),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="deeper"):
        render(scene, MegakernelPathIntegrator(strict=True), spp=1,
               device="cpu")
    tables = mkb.pack_scene_bvh(scene)
    with pytest.raises(ValueError, match="deep"):
        mkb._check_tables(tables, torch.device("cpu"))


def test_conversion_takes_lobes_and_refuses_overrides():
    """scene_from_numpy builds each lobe with its parameters; a
    specular_reflectance texture is converted but keeps the scene off the
    megakernels, as in the JAX package."""
    jscene = _jax_lobe_cornell(4, 4)
    d = export_scene(jscene)
    scene = scene_from_numpy(d, device="cpu")
    kinds = [type(b).__name__ for b in scene.bsdfs[3:]]
    assert kinds == ["RoughConductor", "RoughDielectric", "SmoothConductor",
                     "SmoothDielectric"]
    assert float(scene.bsdfs[3].alpha) == pytest.approx(0.2)
    d["bsdfs"][5] = dict(d["bsdfs"][5],
                         specular_reflectance=np.full(3, 0.5, np.float32))
    tinted = scene_from_numpy(d, device="cpu")
    assert tinted.bsdfs[5].specular_reflectance is not None
    assert plugin_subset_ok(scene) and not plugin_subset_ok(tinted)
