"""Plastic, two-sided and bitmap-textured surfaces in the port against
mitsuba_tpu, on the CPU: the BSDF and texture models, the surface bounce
of the three path megakernels' plain versions, and the wavefront
``PathIntegrator`` and the ``DirectIntegrator`` over them.

The eager models agree per value at rtol = atol = 1e-5 (the BSDFs) and
1e-6 (the texture).  Whole paths share the (seed, lane, dim) stream, so
per-lane radiance agrees to float rounding except on the rare lane where
rounding flips a russian-roulette or visibility decision (the bar of
tests/test_megakernel.py: 99.5 % of lanes within 2e-3, the mean within
2e-3).  The JAX references are few and small, because the JAX package
compiles each one first: one interpret-mode megakernel for every new
code, the rest through the JAX wavefront.
"""
import logging
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.models.bsdfs as jbsdfs
import mitsuba_tpu.models.textures as jtextures
from mitsuba_tpu.models.integrators import DirectIntegrator as JDirect
from mitsuba_tpu.models.integrators import PathIntegrator as JPath
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.ops.pallas.megakernel import megakernel_trace as jtrace
from mitsuba_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
import mitsuba_tpu_torch.models.bsdfs as bsdfs
import mitsuba_tpu_torch.models.textures as textures
from mitsuba_tpu_torch import (DirectIntegrator, MegakernelPathIntegrator,
                               PathIntegrator, sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.shapes import Mesh
from mitsuba_tpu_torch.ops import megakernel_bvh as mkb
from mitsuba_tpu_torch.ops.megakernel import (megakernel_applicable,
                                              megakernel_trace, pack_scene,
                                              plugin_subset_ok, scene_btypes)
from mitsuba_tpu_torch.utils.scenes import checker_bitmap
from torch_parity import export_scene, jax_scene_with_ball

SEED, SPP = 5, 2
DEPTH, RR = 4, 3   # the paths on the 1,316-face scene
TOL = dict(rtol=1e-5, atol=1e-5)
ROUGH_CU = dict(eta=jnp.asarray([0.2, 0.92, 1.1]),
                k=jnp.asarray([3.9, 2.45, 2.14]), alpha=jnp.float32(0.25))


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


def _rgb(v):
    return jtextures.ConstantTexture(jnp.asarray(v, jnp.float32))


def _trgb(v):
    return textures.ConstantTexture(torch.tensor(v))


def _bitmap(h, w, c, seed, nearest=False, wrap=True):
    return jtextures.BitmapTexture(
        data=jnp.asarray(checker_bitmap(h, w, c, seed, cells=2)),
        filter_nearest=nearest, wrap_repeat=wrap)


def _flipped(m):
    """A JAX mesh with its winding reversed (its back faces face out)."""
    return m.replace(faces=jnp.asarray(_np(m.faces)[:, ::-1].copy()))


# ---------------------------------------------------------- eager models

class _SI(SimpleNamespace):
    """A surface interaction of wi and uv, with JAX's ``replace``."""

    def replace(self, **kw):
        return _SI(**{**vars(self), **kw})


def _directions(n, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:4] = [[0, 0, 1], [0.9999, 0, 0.01414], [0, -0.99995, 0.01], [0, 0, -1]]
    return v.astype(np.float32)


def _plastic(rough, nonlinear):
    refl = [0.6, 0.2, 0.3]
    kw = dict(eta=jnp.float32(1.49), nonlinear=nonlinear)
    tkw = dict(eta=torch.tensor(1.49), nonlinear=nonlinear)
    if rough:
        return (jbsdfs.RoughPlastic(_rgb(refl), alpha=jnp.float32(0.3), **kw),
                bsdfs.RoughPlastic(_trgb(refl), alpha=torch.tensor(0.3),
                                   **tkw))
    return (jbsdfs.SmoothPlastic(_rgb(refl), **kw),
            bsdfs.SmoothPlastic(_trgb(refl), **tkw))


def _bsdf_pair(kind):
    """(JAX BSDF, the port's) of one kind."""
    if kind == "plastic":
        return _plastic(rough=False, nonlinear=True)
    if kind == "roughplastic":
        return _plastic(rough=True, nonlinear=False)
    if kind == "twosided-diffuse":
        refl = [0.7, 0.3, 0.2]
        return (jbsdfs.TwoSided(jbsdfs.SmoothDiffuse(_rgb(refl))),
                bsdfs.TwoSided(bsdfs.SmoothDiffuse(_trgb(refl))))
    if kind == "twosided-plastic":
        jb, tb = _plastic(rough=True, nonlinear=True)
        return jbsdfs.TwoSided(jb), bsdfs.TwoSided(tb)
    return (jbsdfs.TwoSided(jbsdfs.RoughConductor(**ROUGH_CU)),
            bsdfs.TwoSided(bsdfs.RoughConductor(
                **{k: torch.tensor(_np(v)) for k, v in ROUGH_CU.items()})))


@pytest.mark.parametrize("kind", ["plastic", "roughplastic",
                                  "twosided-diffuse", "twosided-plastic",
                                  "twosided-roughconductor"])
def test_bsdf_matches_jax(kind):
    """``sample`` (direction, pdf, eta, delta, lobe flags, weight) and
    ``eval_pdf`` per lane, with wi on both sides of the surface, at random
    lobe and direction samples."""
    jb, tb = _bsdf_pair(kind)
    n = 1024
    wi, wo = _directions(n, 8), _directions(n, 9)
    r = np.random.default_rng(10)
    s1 = r.random(n).astype(np.float32)
    s2 = r.random((n, 2)).astype(np.float32)
    active = r.random(n) < 0.9
    jsi = _SI(wi=jnp.asarray(wi), uv=jnp.zeros((n, 2)))
    tsi = _SI(wi=torch.tensor(wi), uv=torch.zeros(n, 2))
    jbs, jw = jb.sample(jsi, jnp.asarray(s1), jnp.asarray(s2),
                        jnp.asarray(active))
    tbs, tw = tb.sample(tsi, torch.tensor(s1), torch.tensor(s2),
                        torch.tensor(active))
    ok = _np(jbs.pdf) > 0
    assert ok.mean() > 0.2
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
    if kind.startswith("twosided"):   # the back side evaluates too
        assert ((wi[:, 2] < 0) & (_np(jp) > 0)).sum() > 100


@pytest.mark.parametrize("filt,wrap,channels", [
    ("bilinear", "repeat", 3), ("nearest", "clamp", 1),
    ("bilinear", "clamp", 1), ("nearest", "repeat", 3)])
def test_bitmap_matches_jax(filt, wrap, channels):
    """BitmapTexture.eval at uvs in [-1.5, 2.5] (wrapped or clamped),
    texel corners and centres included, on an odd-sized bitmap."""
    data = checker_bitmap(13, 21, channels, 3)
    r = np.random.default_rng(4)
    uv = r.uniform(-1.5, 2.5, (4096, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [1, 1], [0.5 / 21, 1 - 0.5 / 13], [1, 0]]
    jt = jtextures.BitmapTexture(data=jnp.asarray(data),
                                 filter_nearest=filt == "nearest",
                                 wrap_repeat=wrap == "repeat")
    tt = textures.BitmapTexture(data=torch.tensor(data),
                                filter_nearest=filt == "nearest",
                                wrap_repeat=wrap == "repeat")
    got = tt.eval(SimpleNamespace(uv=torch.tensor(uv)))
    want = jt.eval(SimpleNamespace(uv=jnp.asarray(uv)))
    assert tuple(got.shape) == (4096, channels)
    _close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="mip"):
        textures.BitmapTexture(data=tt.data, mips=(tt.data,)).eval(
            SimpleNamespace(uv=torch.tensor(uv), duv_dx=torch.zeros(4096, 2)))


# ---------------------------------------------------------- the surface scenes

def _surface_bsdfs():
    """The new BSDFs of the test scenes, in order: SmoothPlastic
    (nonlinear), RoughPlastic, TwoSided(SmoothDiffuse), a 6x6x3 bilinear
    bitmap that wraps, a 4x4x1 nearest bitmap that clamps, and
    TwoSided(RoughConductor).  The bitmaps are small because the
    interpret-mode JAX kernel sweeps its whole arena at each fetch."""
    return [jbsdfs.SmoothPlastic(_rgb([0.6, 0.2, 0.3]), eta=jnp.float32(1.49),
                                 nonlinear=True),
            jbsdfs.RoughPlastic(_rgb([0.2, 0.5, 0.7]), eta=jnp.float32(1.6),
                                alpha=jnp.float32(0.3)),
            jbsdfs.TwoSided(jbsdfs.SmoothDiffuse(_rgb([0.7, 0.3, 0.2]))),
            jbsdfs.SmoothDiffuse(_bitmap(6, 6, 3, 1)),
            jbsdfs.SmoothDiffuse(_bitmap(4, 4, 1, 2, nearest=True,
                                         wrap=False)),
            jbsdfs.TwoSided(jbsdfs.RoughConductor(**ROUGH_CU))]


def _with_surfaces(base, assign, flipped=()):
    """The JAX scene ``base`` with ``_surface_bsdfs`` appended, the meshes
    of ``assign`` (mesh -> index into them) re-pointed, the back wall's
    uvs scaled by 3 (the bitmap tiles 3x3) and the floor's stretched to
    [-0.25, 1.25] (the clamp shows), and the meshes in ``flipped`` with
    their winding reversed (their back faces face the room)."""
    meshes = list(base.meshes)
    meshes[3] = meshes[3].replace(uvs=meshes[3].uvs * 3.0)
    meshes[1] = meshes[1].replace(uvs=meshes[1].uvs * 1.5 - 0.25)
    for mesh in flipped:
        meshes[mesh] = _flipped(meshes[mesh])
    n = len(base.bsdfs)
    for mesh, k in assign.items():
        meshes[mesh] = meshes[mesh].replace(bsdf_index=n + k)
    bsdfs = list(base.bsdfs) + _surface_bsdfs()[:max(assign.values()) + 1]
    return jmake_scene(meshes, bsdfs, list(base.emitters), base.sensor,
                       use_bvh=False)


@pytest.fixture(scope="module")
def surface_cornell():
    """The JAX Cornell box at 8x8 with codes 0, 5, 6, 7 and 16: the small
    box a SmoothPlastic, the green wall a RoughPlastic, the large box a
    TwoSided(SmoothDiffuse) with reversed winding, the back wall and the
    floor bitmaps; its JAX primary rays (2 spp), and the port's scene."""
    jscene = _with_surfaces(jcornell_box(width=8, height=8),
                            {6: 0, 4: 1, 7: 2, 3: 3, 1: 4}, flipped=(7,))
    jray = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    return jscene, jray, scene_from_numpy(export_scene(jscene), device="cpu")


def test_brute_plain_matches_jax_megakernel(surface_cornell):
    """The brute kernel's plain version against the JAX megakernel_trace
    in interpret mode on the surface Cornell box, 8x8 x 2 spp: every new
    code in one run.  Depth 2 without russian roulette keeps the
    interpret-mode trace of the unrolled bounces short: each surface is
    hit, evaluated toward the light and sampled at the first bounce, and
    the second scores the emitter hits of the sampled directions under
    MIS (the wavefront tests below go the whole depth)."""
    depth, rr = 2, 3
    jscene, (ray, _, _, lane), scene = surface_cornell
    active = np.ones(lane.shape, bool)
    jtris, jlight, F, L, jtex, _ = jpack_scene(jscene)
    want = _np(jtrace(jtris, jlight, lane, ray.o, ray.d, jnp.asarray(active),
                      jnp.uint32(SEED), max_depth=depth, rr_depth=rr,
                      n_faces=F, n_lights=L, btypes=(0, 5, 6, 7, 16),
                      interpret=True, tex=jtex))
    tris, light, tF, tL, tex, _ = pack_scene(scene)
    _close(tris, _np(jtris)[:F], rtol=0, atol=1e-6)
    _close(tex, _np(jtex).reshape(-1)[:tex.numel()], rtol=0, atol=0)
    assert scene_btypes(scene) == (0, 5, 6, 7, 16)
    got = megakernel_trace(
        tris, light, torch.tensor(_np(lane)), torch.tensor(_np(ray.o)),
        torch.tensor(_np(ray.d)), torch.tensor(active), SEED,
        max_depth=depth, rr_depth=rr, n_faces=tF, n_lights=tL,
        btypes=scene_btypes(scene), tex=tex).numpy()
    _assert_lanes_close(got, want)


@pytest.fixture(scope="module")
def surface_ball():
    """torch_parity's 1,316-face scene at 8x8 with every new code: the ball
    a RoughPlastic, the small box a SmoothPlastic, the red and green walls
    TwoSided(SmoothDiffuse) and TwoSided(RoughConductor) with reversed
    winding, the back wall and the floor bitmaps.  The JAX wavefront's
    per-lane L (2 spp, depth 4, rr 3; brute-force queries, whose hits are
    the BVH's), the JAX scene, and the port's scene and rays."""
    jscene = _with_surfaces(jax_scene_with_ball(8, 8, 3, use_bvh=False),
                            {8: 1, 6: 0, 5: 2, 4: 5, 3: 3, 1: 4},
                            flipped=(4, 5))
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    want = _np(JPath(max_depth=DEPTH, rr_depth=RR).sample(
        jscene, ray, lane, jnp.uint32(SEED), jnp.ones(lane.shape, bool)))
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    return (want, jscene, scene, ray, lane,
            torch.ones(lane.shape, dtype=torch.bool))


@pytest.mark.parametrize("integrator", ["path", "direct"])
def test_integrator_matches_jax(request, integrator):
    """The wavefront PathIntegrator per lane against the JAX one on the
    1,316-face scene with every new code (the port walks its BVH; depth
    4, russian roulette from 3), the DirectIntegrator on the surface
    Cornell box."""
    if integrator == "path":
        want, _, scene, ray, lane, active = request.getfixturevalue(
            "surface_ball")
        got = PathIntegrator(DEPTH, RR).sample(scene, ray, lane, SEED, active)
    else:
        jscene, (jray, _, _, jlane), scene = request.getfixturevalue(
            "surface_cornell")
        want = _np(JDirect().sample(jscene, jray, jlane, jnp.uint32(SEED),
                                    jnp.ones(jlane.shape, bool)))
        ray, _, _, lane = sample_rays(scene, SEED, SPP)
        got = DirectIntegrator().sample(scene, ray, lane, SEED,
                                        torch.ones(lane.shape,
                                                   dtype=torch.bool))
    _assert_lanes_close(got.numpy(), want)


def test_megapath_takes_surface_scene(surface_cornell):
    """MegakernelPathIntegrator(strict=True) takes the surface Cornell box
    on the brute branch (no fallback) and agrees per lane with the
    port's wavefront path at depth 6."""
    _, _, scene = surface_cornell
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    active = torch.ones(lane.shape, dtype=torch.bool)
    got = MegakernelPathIntegrator(6, 5, strict=True).sample(
        scene, ray, lane, SEED, active)
    want = PathIntegrator(6, 5).sample(scene, ray, lane, SEED, active)
    _assert_lanes_close(got.numpy(), want.numpy())


# ---------------------------------------------------------- the BVH branch

def test_bvh_surfaces_match_jax_wavefront(surface_ball, monkeypatch):
    """The BVH kernels' plain versions on the textured scene, per-depth
    sorted (the bounce kernel) and the plain bounce looped over unsorted
    lanes, per lane against the JAX wavefront, and equal to each other;
    ``sort_bounces=False`` still takes the bounce kernel for a textured
    scene, and the single launch refuses the textured codes.  Without
    the textures the single launch runs and equals the sorted path."""
    want, _, scene, ray, lane, active = surface_ball
    assert scene.accel is not None and mkb.megakernel_bvh_applicable(scene)
    btypes = scene_btypes(scene)
    assert btypes == (0, 5, 6, 7, 16, 19)
    sorted_L = MegakernelPathIntegrator(DEPTH, RR, strict=True).sample(
        scene, ray, lane, SEED, active)
    _assert_lanes_close(sorted_L.numpy(), want)
    tables = mkb.pack_scene_bvh(scene)
    plain = mkb.megakernel_trace_bvh_plain(tables, lane, ray.o, ray.d,
                                           active, SEED, DEPTH, RR,
                                           smooth=True, btypes=btypes)
    torch.testing.assert_close(plain, sorted_L, rtol=0, atol=0)
    with pytest.raises(ValueError, match="textured"):
        mkb.megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, SEED,
                                 DEPTH, RR, smooth=True, btypes=btypes)

    def no_single_launch(*args, **kw):
        raise AssertionError("a textured scene took the single launch")

    with monkeypatch.context() as m:
        m.setattr("mitsuba_tpu_torch.models.integrators.megapath."
                  "megakernel_trace_bvh", no_single_launch)
        unsorted = MegakernelPathIntegrator(
            DEPTH, RR, sort_bounces=False).sample(scene, ray, lane, SEED,
                                                  active)
    torch.testing.assert_close(unsorted, sorted_L, rtol=0, atol=0)

    bsdfs = [scene.bsdfs[0] if isinstance(getattr(b, "reflectance", None),
                                          textures.BitmapTexture) else b
             for b in scene.bsdfs]   # the bitmaps -> the constant white
    plain_scene = make_scene(scene.meshes, bsdfs, scene.emitters,
                             scene.sensor, "cpu")
    assert scene_btypes(plain_scene) == (0, 6, 7, 16, 19)
    single = MegakernelPathIntegrator(DEPTH, RR, sort_bounces=False).sample(
        plain_scene, ray, lane, SEED, active)
    torch.testing.assert_close(single, MegakernelPathIntegrator(
        DEPTH, RR).sample(plain_scene, ray, lane, SEED, active),
        rtol=0, atol=0)


# ---------------------------------------------------------- conversion

def test_conversion_round_trips_surfaces(surface_cornell, surface_ball,
                                         caplog):
    """scene_from_numpy builds each new type with its parameters, a
    plastic over a bitmap converts but leaves the kernels' subset, and a
    TwoSided dielectric leaves it too: MegakernelPathIntegrator falls back
    to the wavefront path, logged."""
    jscene, _, scene = surface_cornell
    kinds = [type(b).__name__ for b in scene.bsdfs[3:]]
    assert kinds == ["SmoothPlastic", "RoughPlastic", "TwoSided",
                     "SmoothDiffuse", "SmoothDiffuse"]
    sp, rp, ts, tex_rgb, tex_gray = scene.bsdfs[3:]
    assert sp.nonlinear and not rp.nonlinear
    assert float(sp.eta) == pytest.approx(1.49)
    assert float(rp.alpha) == pytest.approx(0.3)
    assert type(ts.nested).__name__ == "SmoothDiffuse"
    assert type(surface_ball[2].bsdfs[-1].nested).__name__ == "RoughConductor"
    assert not tex_rgb.reflectance.filter_nearest \
        and tex_rgb.reflectance.wrap_repeat
    assert tex_gray.reflectance.filter_nearest \
        and not tex_gray.reflectance.wrap_repeat
    np.testing.assert_array_equal(tex_gray.reflectance.data.numpy(),
                                  _np(jscene.bsdfs[7].reflectance.data))
    assert megakernel_applicable(scene)

    d = export_scene(jscene)
    textured_plastic = dict(d["bsdfs"][3], diffuse_reflectance=d["bsdfs"][6][
        "reflectance"])
    d2 = dict(d, bsdfs=d["bsdfs"][:3] + [textured_plastic] + d["bsdfs"][4:])
    assert not plugin_subset_ok(scene_from_numpy(d2, device="cpu"))

    glass = {"type": "twosided",
             "nested": {"type": "dielectric", "eta": np.float32(1.5)}}
    d3 = dict(d, bsdfs=d["bsdfs"][:5] + [glass] + d["bsdfs"][6:])
    glassy = scene_from_numpy(d3, device="cpu")
    assert not plugin_subset_ok(glassy)
    ray, _, _, lane = sample_rays(glassy, SEED, 1)
    active = torch.ones(lane.shape, dtype=torch.bool)
    with caplog.at_level(logging.INFO, "mitsuba_tpu_torch"):
        got = MegakernelPathIntegrator(4, 3).sample(glassy, ray, lane, SEED,
                                                    active)
    assert "falling back" in caplog.text
    torch.testing.assert_close(got, PathIntegrator(4, 3).sample(
        glassy, ray, lane, SEED, active), rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside"):
        MegakernelPathIntegrator(4, 3, strict=True).sample(
            glassy, ray, lane, SEED, active)


# ---------------------------------------------------------- Mesh.make's device

def test_mesh_make_on_the_cpu():
    """Mesh.make builds on the CPU when asked."""
    m = Mesh.make(np.eye(3), np.arange(3).reshape(1, 3), uvs=np.zeros((3, 2)),
                  device="cpu")
    assert m.vertices.device.type == "cpu"
    assert m.vertices.dtype == torch.float32
    assert m.faces.dtype == torch.int64 and m.normals is None


def test_mesh_make_needs_a_device_choice():
    """Mesh.make defaults to the GPU, as every entry point of the port:
    without one it raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh.make(np.eye(3), np.arange(3).reshape(1, 3))
