"""Environment-map lighting in the port against mitsuba_tpu, on the CPU:
``Marginal2D``, ``EnvmapEmitter``, the kernels' NEE draw
(``env_nee_sample``) and escape and two-emitter pick in the plain bounce,
the wavefront ``PathIntegrator`` and ``DirectIntegrator``, the BVH
kernels' plain per-depth path, the gates and the conversion.

The eager models agree per value at 1e-6 (the distribution) and
rtol = atol = 1e-5 (the emitter, the NEE candidates).  Whole paths share
the (seed, lane, dim) stream, so per-lane radiance agrees to float
rounding but on the rare lane where rounding flips a russian-roulette or
visibility decision (the bar of tests/test_megakernel.py: 99.5 % of lanes
within 2e-3, the mean within 2e-3).  The scenes are the JAX package's own
envmap case (tests/test_megakernel.py ``_env_scene``: a floor, a ball, a
16 x 32 map with a bright patch, the area light before the map) at 8 x 8;
the JAX references are few, because the JAX package compiles each one
first: one interpret-mode megakernel, the rest through its wavefront.
"""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.distr2d import Marginal2D as JMarginal2D
from mitsuba_tpu.models.bsdfs import SmoothDiffuse as JDiffuse
from mitsuba_tpu.models.emitters import AreaEmitter as JArea
from mitsuba_tpu.models.emitters import EnvmapEmitter as JEnvmap
from mitsuba_tpu.models.film import Film as JFilm
from mitsuba_tpu.models.film import ReconstructionFilter as JFilter
from mitsuba_tpu.models.integrators import DirectIntegrator as JDirect
from mitsuba_tpu.models.integrators import PathIntegrator as JPath
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.models.integrators.megapath import _env_nee_table
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.models.sensors import PerspectiveCamera as JCamera
from mitsuba_tpu.models.shapes import Mesh as JMesh
from mitsuba_tpu.models.shapes import rectangle as jrectangle
from mitsuba_tpu.models.shapes import sphere_mesh as jsphere_mesh
from mitsuba_tpu.models.textures import ConstantTexture as JConstant
from mitsuba_tpu.ops.pallas.megakernel import _plugin_subset_ok
from mitsuba_tpu.ops.pallas.megakernel import megakernel_trace as jtrace
from mitsuba_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from mitsuba_tpu_torch import (DirectIntegrator, MegakernelPathIntegrator,
                               PathIntegrator, sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.core.distr2d import Marginal2D
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.models.emitters import EnvmapEmitter
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.ops import megakernel_bvh as mkb
from mitsuba_tpu_torch.ops.megakernel import (env_nee_sample, env_view,
                                              megakernel_applicable,
                                              megakernel_trace, pack_scene,
                                              plugin_subset_ok, scene_btypes)
from mitsuba_tpu_torch.utils.scenes import envmap_scene
from torch_parity import export_scene, jax_scene_with_ball

SEED, SPP = 5, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _assert_lanes_close(got, want):
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} lanes match"
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def _env_data(h=16, w=32, seed=1):
    """The JAX package's test map: uniform radiance and a bright patch."""
    data = np.random.default_rng(seed).uniform(0.05, 1.5, (h, w, 3))
    data = data.astype(np.float32)
    data[3:6, 8:12] *= 8.0
    return data


def _jenvmap(to_world=None, data=None):
    return JEnvmap.create(_env_data() if data is None else data, scale=1.0,
                          to_world=to_world)


def _jscene(emitters, width=8, height=8):
    """The JAX envmap case (tests/test_megakernel.py ``_env_scene``) lit by
    ``emitters``, a list of "area" and "env" in order."""
    white = JDiffuse(reflectance=JConstant(jnp.full(3, 0.7)))
    meshes = [JMesh.make(*jrectangle(np.asarray(jtf.compose(
        jtf.translate([0, -1, 0]), jtf.rotate([1, 0, 0], -90),
        jtf.scale(3.0)), np.float32)), bsdf_index=0, id="floor")]
    v, f, n, uv = jsphere_mesh(2, np.asarray(jtf.compose(
        jtf.translate([0, -0.4, 0]), jtf.scale(0.6)), np.float32))
    meshes.append(JMesh.make(v, f, normals=n, uvs=uv, bsdf_index=0,
                             id="ball"))
    ems = []
    for i, kind in enumerate(emitters):
        if kind == "env":
            ems.append(_jenvmap())
            continue
        meshes.append(JMesh.make(*jrectangle(np.asarray(jtf.compose(
            jtf.translate([0, 2.0, 0]), jtf.rotate([1, 0, 0], 90),
            jtf.scale(0.5)), np.float32)), bsdf_index=0, emitter_index=i,
            id="light"))
        ems.append(JArea(radiance=JConstant(jnp.full(3, 10.0))))
    cam = JCamera(to_world=jnp.asarray(jtf.look_at([0, 0.5, -4],
                                                   [0, -0.3, 0], [0, 1, 0])),
                  fov=45.0, film=JFilm(width=width, height=height,
                                       rfilter=JFilter.box()))
    return jmake_scene(meshes, [white], ems, cam, use_bvh=False)


# ---------------------------------------------------------- eager models

def test_marginal2d_matches_jax():
    """Marginal2D over the JAX package's own table (zero rows and cells
    included): the sampled cells equal the JAX count of CDF entries below
    u, uv and pdf at 1e-6; its own table within 1e-6 of the JAX one."""
    r = np.random.default_rng(0)
    table = r.random((13, 21)).astype(np.float32)
    table[2] = 0.0
    table[5, 3:9] = 0.0
    jm = JMarginal2D.create(jnp.asarray(table))
    fields = ("pdf_table", "row_cdf", "cond_cdf", "row_weight", "total")
    m = Marginal2D(**{k: torch.tensor(_np(getattr(jm, k))) for k in fields})
    own = Marginal2D.create(torch.tensor(table))
    for k in fields:
        np.testing.assert_allclose(getattr(own, k).numpy(),
                                   _np(getattr(jm, k)), rtol=1e-6, atol=1e-6)
    u = r.random((4096, 2)).astype(np.float32)
    u[:6] = [[0, 0], [1 - 2 ** -24] * 2, [0.5, 0.5], [0, 1 - 2 ** -24],
             [_np(jm.cond_cdf)[3, 4], _np(jm.row_cdf)[3]],
             [0.3, _np(jm.row_cdf)[1]]]
    row = np.clip((_np(jm.row_cdf)[None] < u[:, 1:2]).sum(1), 0, 12)
    col = np.clip((_np(jm.cond_cdf)[row] < u[:, 0:1]).sum(1), 0, 20)
    trow, tcol = m.sample_cells(torch.tensor(u))
    np.testing.assert_array_equal(trow.numpy(), row)
    np.testing.assert_array_equal(tcol.numpy(), col)
    juv, jpdf = jm.sample(jnp.asarray(u))
    tuv, tpdf = m.sample(torch.tensor(u))
    np.testing.assert_allclose(tuv.numpy(), _np(juv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy(), _np(jpdf), rtol=1e-6, atol=1e-6)
    uv = r.uniform(-0.1, 1.1, (4096, 2)).astype(np.float32)
    np.testing.assert_allclose(m.pdf(torch.tensor(uv)).numpy(),
                               _np(jm.pdf(jnp.asarray(uv))), rtol=1e-6,
                               atol=1e-6)


def test_envmap_emitter_matches_jax():
    """EnvmapEmitter's eval_env, sample_direction, pdf_direction and
    eval_direction against the JAX one under a rotated to_world, at
    rtol = atol = 1e-5 (the poles and the -z seam among the directions);
    its own sampling table agrees with the JAX one at 1e-6."""
    to_world = np.asarray(jtf.rotate([0.3, 1.0, -0.2], 37.0))
    je = _jenvmap(to_world)
    data = _np(je.data)
    fields = ("pdf_table", "row_cdf", "cond_cdf", "row_weight", "total")
    te = EnvmapEmitter.create(data, to_world=to_world, device="cpu",
                              distr=Marginal2D(**{
                                  k: torch.tensor(_np(getattr(je.distr, k)))
                                  for k in fields}))
    own = EnvmapEmitter.create(data, to_world=to_world, device="cpu")
    np.testing.assert_allclose(own.distr.pdf_table.numpy(),
                               _np(je.distr.pdf_table), rtol=1e-6)
    r = np.random.default_rng(2)
    n = 2048
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[0, 1, 0], [0, -1, 0], [0, 0, -1]]
    d = d.astype(np.float32)
    active = r.random(n) < 0.9
    np.testing.assert_allclose(
        te.eval_env(torch.tensor(d), torch.tensor(active)).numpy(),
        _np(je.eval_env(jnp.asarray(d), jnp.asarray(active))), **TOL)
    s2 = r.random((n, 2)).astype(np.float32)
    p = r.normal(size=(n, 3)).astype(np.float32)
    jds, jw = je.sample_direction(jnp.asarray(p), jnp.zeros(n),
                                  jnp.asarray(s2))
    tds, tw = te.sample_direction(torch.tensor(p), torch.zeros(n),
                                  torch.tensor(s2))
    for field in ("d", "p", "uv", "pdf", "dist"):
        np.testing.assert_allclose(getattr(tds, field).numpy(),
                                   _np(getattr(jds, field)), **TOL)
    np.testing.assert_allclose(tw.numpy(), _np(jw), **TOL)
    np.testing.assert_allclose(
        te.pdf_direction(torch.tensor(p), tds).numpy(),
        _np(je.pdf_direction(jnp.asarray(p), jds)), **TOL)
    np.testing.assert_allclose(
        te.eval_direction(torch.tensor(p), tds).numpy(),
        _np(je.eval_direction(jnp.asarray(p), jds)), **TOL)
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        te.sample_ray(None, None, None, None)


# ---------------------------------------------------------- the brute kernel

@pytest.fixture(scope="module")
def area_env():
    """The JAX envmap case with the area light first and the map second
    (env_pos 1), its primary rays at 8 x 8 x 2 spp, the JAX package's NEE
    table of two depths for them, and the port's scene."""
    jscene = _jscene(["area", "env"])
    ray = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    table = _env_nee_table(jscene, ray[3], jnp.uint32(SEED), 2)
    return (jscene, ray, table,
            scene_from_numpy(export_scene(jscene), device="cpu"))


def test_env_nee_sample_matches_jax(area_env):
    """env_nee_sample, the kernels' NEE draw, against the JAX package's
    per-(lane, depth) table, _env_nee_table, at each depth."""
    jscene, (_, _, _, lane), table, scene = area_env
    table = _np(table)
    env = env_view(**pack_scene(scene)[5])
    for k in range(2):
        np.testing.assert_allclose(
            env_nee_sample(env, SEED, torch.tensor(_np(lane)), k).numpy(),
            table[:, 8 * k:8 * k + 8], **TOL)


def test_brute_plain_matches_jax_megakernel(area_env):
    """The brute kernel's plain version against the JAX megakernel_trace
    in interpret mode on the two-emitter envmap case: the escape under
    MIS, the uniform two-emitter pick, the envmap's NEE candidate and the
    area pdf times its selection pmf.  Depth 2 keeps the interpret-mode
    trace short: every escape, pick and candidate of the first bounce,
    and the escapes and light hits of its sampled directions."""
    depth, rr = 2, 3
    jscene, (ray, _, _, lane), table, scene = area_env
    assert _plugin_subset_ok(jscene) and megakernel_applicable(scene)
    active = np.ones(lane.shape, bool)
    jtris, jlight, F, L, jtex, jmeta = jpack_scene(jscene)
    want = _np(jtrace(jtris, jlight, lane, ray.o, ray.d, jnp.asarray(active),
                      jnp.uint32(SEED), max_depth=depth, rr_depth=rr,
                      n_faces=F, n_lights=L, btypes=(0,), interpret=True,
                      tex=jtex, env_meta=jmeta, env_nee=table[:, :8 * depth],
                      env_pos=1, smooth=True))
    tris, light, tF, tL, tex, env = pack_scene(scene)
    assert (tF, tL, env["env_pos"]) == (F, L, 1)
    # the same rotation, scale, size, table total and selection pmfs; the
    # arena offsets (12, 13) are each layout's own
    same = np.r_[0:12, 14:17]
    np.testing.assert_array_equal(env["env_meta"].numpy()[same],
                                  _np(jmeta)[0, same])
    got = megakernel_trace(
        tris, light, torch.tensor(_np(lane)), torch.tensor(_np(ray.o)),
        torch.tensor(_np(ray.d)), torch.tensor(active), SEED,
        max_depth=depth, rr_depth=rr, n_faces=tF, n_lights=tL,
        btypes=scene_btypes(scene), tex=tex, smooth=True, **env).numpy()
    _assert_lanes_close(got, want)
    # MegakernelPathIntegrator takes the scene on the brute branch
    rays = Ray(o=torch.tensor(_np(ray.o)), d=torch.tensor(_np(ray.d)),
               maxt=torch.tensor(_np(ray.maxt)))
    np.testing.assert_array_equal(MegakernelPathIntegrator(
        depth, rr, strict=True).sample(scene, rays, torch.tensor(_np(lane)),
                                       SEED, torch.tensor(active)).numpy(),
        got)


# ---------------------------------------------------------- the integrators

@pytest.mark.parametrize("emitters,integrators", [
    (["env"], ("path", "direct")), (["env", "area"], ("path",)),
    (["area", "env"], ("direct",))])
def test_integrators_match_jax(emitters, integrators):
    """The wavefront PathIntegrator (depth 4, russian roulette from 3)
    and the DirectIntegrator per lane against the JAX ones: both on the
    envmap alone, and each on a two-emitter scene, the map second for the
    direct integrator and first for the path integrator (which the BVH
    test below also runs with the map second)."""
    jscene = _jscene(emitters)
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    assert scene.env_index == jscene.env_index
    jray, _, _, jlane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    active = torch.ones(lane.shape, dtype=torch.bool)
    jactive = jnp.ones(jlane.shape, bool)
    pairs = {"path": (PathIntegrator(4, 3), JPath(max_depth=4, rr_depth=3)),
             "direct": (DirectIntegrator(), JDirect())}
    for kind in integrators:
        port, jax_integrator = pairs[kind]
        _assert_lanes_close(
            port.sample(scene, ray, lane, SEED, active).numpy(),
            _np(jax_integrator.sample(jscene, jray, jlane, jnp.uint32(SEED),
                                      jactive)))


# ---------------------------------------------------------- the BVH branch

def test_bvh_envmap_matches_jax_wavefront(monkeypatch):
    """torch_parity's 1,316-face scene lit by its area light and the
    16 x 32 map (env_pos 1): the port's PathIntegrator over its BVH
    queries and the BVH kernels' plain per-depth path, sorted and with
    sort_bounces=False (which must still take the per-depth pipeline),
    per lane against the JAX wavefront; the single launch refuses the
    map."""
    base = jax_scene_with_ball(8, 8, 3, use_bvh=False)
    jscene = jmake_scene(base.meshes, base.bsdfs,
                         list(base.emitters) + [_jenvmap()], base.sensor,
                         use_bvh=False)
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    want = _np(JPath(max_depth=4, rr_depth=3).sample(
        jscene, ray, lane, jnp.uint32(SEED), jnp.ones(lane.shape, bool)))
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    assert scene.accel is not None and mkb.megakernel_bvh_applicable(scene)
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    active = torch.ones(lane.shape, dtype=torch.bool)
    _assert_lanes_close(PathIntegrator(4, 3).sample(
        scene, ray, lane, SEED, active).numpy(), want)
    sorted_L = MegakernelPathIntegrator(4, 3, strict=True).sample(
        scene, ray, lane, SEED, active)
    _assert_lanes_close(sorted_L.numpy(), want)

    def no_single_launch(*args, **kw):
        raise AssertionError("an envmap scene took the single launch")

    with monkeypatch.context() as m:
        m.setattr("mitsuba_tpu_torch.models.integrators.megapath."
                  "megakernel_trace_bvh", no_single_launch)
        unsorted = MegakernelPathIntegrator(4, 3, sort_bounces=False).sample(
            scene, ray, lane, SEED, active)
    torch.testing.assert_close(unsorted, sorted_L, rtol=0, atol=0)
    tables = mkb.pack_scene_bvh(scene)
    with pytest.raises(ValueError, match="environment"):
        mkb.megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, SEED, 4,
                                 3, smooth=True, btypes=scene_btypes(scene))


# ---------------------------------------------------------- gates, conversion

def test_gates_and_conversion(area_env, caplog):
    """The port takes a 1024 x 2048 map, which the JAX kernels' VMEM cap
    refuses; two maps or a sampling weight other than 1 fall back to the
    wavefront path, logged; the conversion keeps the map, its table and
    its parameters."""
    jscene, _, _, scene = area_env
    env = scene.environment
    je = jscene.environment
    np.testing.assert_array_equal(env.data.numpy(), _np(je.data))
    for k in ("pdf_table", "row_cdf", "cond_cdf", "row_weight", "total"):
        np.testing.assert_array_equal(getattr(env.distr, k).numpy(),
                                      _np(getattr(je.distr, k)))
    assert float(env.scale) == float(je.scale)
    assert env.scene_radius == pytest.approx(float(je.scene_radius))
    np.testing.assert_array_equal(env.to_world.numpy(), _np(je.to_world))

    big = np.full((1024, 2048, 3), 0.5, np.float32)
    jbig = jscene.replace(emitters=(jscene.emitters[0],
                                    je.replace(data=jnp.asarray(big))))
    assert not _plugin_subset_ok(jbig)
    port_big = envmap_scene(8, 8, area_light=True, env=big, device="cpu")
    assert plugin_subset_ok(port_big) and megakernel_applicable(port_big)

    two = make_scene(scene.meshes, scene.bsdfs,
                     list(scene.emitters) + [scene.environment], scene.sensor,
                     "cpu")
    weighted = make_scene(scene.meshes, scene.bsdfs, [
        scene.emitters[0], dataclasses.replace(env, sampling_weight=2.0)],
        scene.sensor, "cpu")
    ray, _, _, lane = sample_rays(scene, SEED, 1)
    active = torch.ones(lane.shape, dtype=torch.bool)
    for other in (two, weighted):
        assert not plugin_subset_ok(other)
        caplog.clear()
        with caplog.at_level(logging.INFO, "mitsuba_tpu_torch"):
            got = MegakernelPathIntegrator(2, 3).sample(other, ray, lane,
                                                        SEED, active)
        assert "falling back" in caplog.text
        torch.testing.assert_close(got, PathIntegrator(2, 3).sample(
            other, ray, lane, SEED, active), rtol=0, atol=0)
        with pytest.raises(ValueError, match="outside"):
            MegakernelPathIntegrator(2, 3, strict=True).sample(
                other, ray, lane, SEED, active)
