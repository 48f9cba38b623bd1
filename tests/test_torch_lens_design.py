"""The port's lens-design path against mitsuba_tpu, on the CPU.

The lens is the doublet of examples/doublet_achromat_design.py, meshed
at 3 rings x 8 sectors, its rear surface solved for EFL = 50 mm; the
design problem is the example's (one collimated source, the spot sensor
at 0.01 of the rear z, spectral), at an 8x8 film and 16 light paths a
pixel.  One jitted JAX program (``jax_design``) gives the references:
the loss and ``jax.value_and_grad`` of every parameter at two points,
the start and the point after one Adam step.  The port's lens is carried
across by ``convert.lens_from_numpy``; its loss must match within 1e-4
and each parameter's gradient within 1e-3 in relative norm.  The
paraxial analysis and the remeshed vertices and normals are held against
the JAX package's on the doublet and the triplet.

Two faults of the reference are repaired in the port (ROADMAP.md, Queue
3), and those cases expect the difference: a draw with a non-finite loss
and finite gradients is redrawn, and the per-sensor drop counts survive
a resumed checkpoint.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.lens import ConicSurface as JConic
from mitsuba_tpu.lens import DesignProblem as JDesign
from mitsuba_tpu.lens import EvenAsphericSurface as JAsphere
from mitsuba_tpu.lens import LensMaterial as JMaterial
from mitsuba_tpu.lens import LensSystem as JLensSystem
from mitsuba_tpu.lens.lens_system import _sag_normals as jsag_normals
from mitsuba_tpu.utils import optimizers as joptim
from mitsuba_tpu_torch.convert import lens_from_numpy
from mitsuba_tpu_torch.lens import (ConicSurface, DesignProblem, LensMaterial,
                                    LensSystem, accumulate_sensor_grads)
from mitsuba_tpu_torch.lens.lens_system import _sag_normals
from mitsuba_tpu_torch.lens.surfaces import EvenAsphericSurface
from mitsuba_tpu_torch.ops.bvh import refit_bvh
from mitsuba_tpu_torch.utils.elastic import CheckpointedLoop, nan_guard_step
from mitsuba_tpu_torch.utils.optimizers import Adam
from mitsuba_tpu_torch.utils.params import refresh_accel
from torch_parity import export_lens

LR = 2e-3
DOUBLET = [(8.0, 1.0 / 140.0, 48.0), (8.0, -1.0 / 24.0, 49.0),
           (8.0, 1.0 / 24.0, 52.0)]
TRIPLET = [(6.5, -17.285, 42.95), (6.5, 141.25, 44.95), (5.0, 19.3, 50.95),
           (5.0, -20.25, 51.95), (6.5, -158.65, 57.95), (6.5, 21.25, 59.95)]


def _jax_doublet(n_rings=3, n_sectors=8):
    surfaces = [JConic.create(r, c, 0.0, z) for r, c, z in DOUBLET]
    glass = [JMaterial.create("sf11", 1.6447, 0.2 * 64.17),
             JMaterial.create("nbk7", 1.5168, 0.2 * 64.17)]
    ls = JLensSystem.create(surfaces, glass, n_rings=n_rings,
                            n_sectors=n_sectors)
    s0 = ls.surfaces[0].with_params(ls.rear_surface_params_for_EFL(50.0))
    return ls.replace(surfaces=(s0,) + ls.surfaces[1:])


def _jax_triplet(n_rings=8, n_sectors=16):
    surfaces = [JConic.create(r, 1.0 / R, 0.0, z) for r, R, z in TRIPLET]
    glass = [JMaterial.create("sk16", 1.62041, 60.32), JMaterial.create(),
             JMaterial.create("f4", 1.616592, 36.63), JMaterial.create(),
             JMaterial.create("sk16_b", 1.62041, 60.32)]
    ls = JLensSystem.create(surfaces, glass, n_rings=n_rings,
                            n_sectors=n_sectors)
    s0 = ls.surfaces[0].with_params(ls.rear_surface_params_for_EFL(50.0))
    return ls.replace(surfaces=(s0,) + ls.surfaces[1:])


PROBLEM = dict(resolution=(8, 8), spp=16, learning_rate=LR, iters=2,
               num_sources=1, init_camera_z=0.01, seed=0, spectral=True)


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_problem(ls):
    """The JAX package's own DesignProblem of the lens ``ls``, built by its
    ``build``: meshes, sources, sensor poses and templates all its own."""
    from mitsuba_tpu.models.integrators import ParticleTracerIntegrator as JPT

    dp = JDesign(ls, **PROBLEM).build()
    # remat only trades the backward's memory for recomputation; off, the
    # reference program compiles in about half the time
    dp.base_scene = dp.base_scene.replace(integrator=JPT(
        max_depth=ls.size() + 2, rr_depth=64, spectral=True, remat=False))
    return dp


STEP = {"lens1_c": -0.31, "lens1_K": 0.4, "lens2_z0": 52.3, "lens0_c": -0.05}
ASPHERE = dict(radial_extent=6.0, c=0.05, K=-0.5, z0=3.0, a4=1e-4, a6=-2e-6)
ASPHERE_J = JAsphere.create(**ASPHERE)
ASPHERE_XY = np.random.default_rng(0).uniform(-4, 4, (64, 2)).astype(
    np.float32)


@pytest.fixture(scope="module")
def jax_design():
    """The references from one jitted JAX program, called at two points,
    the start (seed 0) and the point after one Adam step (seed 1): the
    loss and its gradient for every parameter, the lens meshes remeshed at
    the start with ``STEP`` applied, and the geometric tracer's film hits
    of the source's central probes.  Also both built problems: the port's
    and the JAX package's, each made by its own ``build``."""
    from mitsuba_tpu.core.records import Ray as JRay
    from mitsuba_tpu.models.integrators import PRBBasicIntegrator as JBasic

    ls = _jax_doublet()
    port_ls, _ = lens_from_numpy(export_lens(ls), device="cpu")
    port = DesignProblem(port_ls, **PROBLEM).build()
    dp = _jax_problem(ls)
    probe = port.sources[0].central_ray("cpu")
    depth = ls.size() + 1

    @jax.jit
    def references(p, seed, o, d, xy):
        v, g = jax.value_and_grad(dp.loss)(p, seed)
        asphere = (ASPHERE_J.sag(xy[:, 0], xy[:, 1]),
                   jsag_normals(ASPHERE_J, xy))
        meshes = dp.apply_params({**p, **STEP}).remesh(
            list(dp.base_scene.meshes), dp.templates, mesh_offset=1)
        _, _, valid, film = JBasic(max_depth=depth + 2).trace(
            dp.geo_scene, JRay.make(o, d), depth)
        return (v, g, [m.vertices for m in meshes],
                [m.normals for m in meshes], valid, film, asphere)

    opt = joptim.Adam(lr=LR)
    p = dp.params()
    state = opt.init(p)
    points, values, grads = [], [], []
    o, d = jnp.asarray(probe.o.numpy()), jnp.asarray(probe.d.numpy())
    for it in range(2):
        v, g, verts, normals, valid, film, asphere = references(
            p, it, o, d, jnp.asarray(ASPHERE_XY))
        if it == 0:
            remeshed = ([np.asarray(x) for x in verts],
                        [None if x is None else np.asarray(x)
                         for x in normals])
        points.append(_numpy(p))
        values.append(float(v))
        grads.append(_numpy(g))
        p, state = opt.step(p, g, state)
    return dict(port=port, jdp=dp, points=points, values=values, grads=grads,
                final=_numpy(p), remeshed=remeshed, probe=probe,
                asphere=[np.asarray(x) for x in asphere],
                probe_valid=np.asarray(valid), probe_film=np.asarray(film))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_build_matches_jax_build(jax_design):
    """The port's ``build`` against the JAX package's own: the sources and
    their probe rays, every mesh of the render scene (the film plane, the
    lenses with their normals, the baffles, the source disks), the
    templates, the geometric tracer's scene, the emitters and each
    sensor's pose, clips and film.  The sensor sits at the mean film hit
    of nine probes; the chief ray's is a tie at the lens fans' centre
    vertex (``test_sensor_placement_matches_jax``), which moves the
    mean's x and y by up to 1e-4 mm, a 500th of a pixel."""
    port, jdp = jax_design["port"], jax_design["jdp"]
    assert len(port.sources) == len(jdp.sources)
    for s, js in zip(port.sources, jdp.sources):
        _close(s.origin, js.origin, 1e-6)
        _close(s.target, js.target, 1e-6)
        assert s.radius == pytest.approx(js.radius, rel=1e-6)
        ray, jray = s.central_ray("cpu"), js.central_ray()
        _close(ray.o.numpy(), jray.o, 1e-6)
        _close(ray.d.numpy(), jray.d, 1e-6)
    sc, jsc = port.base_scene, jdp.base_scene
    assert [m.id for m in sc.meshes] == [m.id for m in jsc.meshes]
    for m, jm in zip(sc.meshes, jsc.meshes):
        assert (m.bsdf_index, m.emitter_index) == (jm.bsdf_index,
                                                   jm.emitter_index), m.id
        np.testing.assert_array_equal(m.faces.numpy(), np.asarray(jm.faces))
        _close(m.vertices.detach().numpy(), jm.vertices, 1e-6)
        assert (m.normals is None) == (jm.normals is None), m.id
        if m.normals is not None:
            _close(m.normals.detach().numpy(), jm.normals, 1e-6)
    assert len(sc.bsdfs) == len(jsc.bsdfs)
    assert [t[0] for t in port.templates] == [t[0] for t in jdp.templates]
    assert [t[2] for t in port.templates] == [t[2] for t in jdp.templates]
    for t, jt in zip(port.templates, jdp.templates):
        _close(t[1].numpy(), jt[1], 1e-6)
    assert [m.id for m in port.geo_scene.meshes] == \
        [m.id for m in jdp.geo_scene.meshes]
    assert len(sc.emitters) == len(jsc.emitters)
    for e, je in zip(sc.emitters, jsc.emitters):
        _close(e.radiance.value.numpy(), je.radiance.value, 1e-7)
    assert len(port.sensors) == len(jdp.sensors)
    for cam, jcam in zip(port.sensors, jdp.sensors):
        m, jm = cam.to_world.numpy(), np.asarray(jcam.to_world)
        _close(m[:, :3], jm[:, :3], 1e-6)
        _close(m[2:, 3], jm[2:, 3], 1e-6)
        np.testing.assert_allclose(m[:2, 3], jm[:2, 3], rtol=0, atol=1e-4)
        assert cam.near_clip == pytest.approx(jcam.near_clip, rel=1e-6)
        assert cam.far_clip == pytest.approx(jcam.far_clip, rel=1e-6)
        assert cam.fov == jcam.fov
        assert (cam.film.width, cam.film.height, cam.film.rfilter.kind) == (
            jcam.film.width, jcam.film.height, jcam.film.rfilter.kind)


def test_sensor_placement_matches_jax(jax_design):
    """The geometric tracer's film hits of the source's probes match the
    JAX package's within 1e-5 mm, but for the chief ray: it meets the
    lens fans at their shared centre vertex, a tie that each package's
    test breaks its own way (the JAX package's note, design.py:57)."""
    port = jax_design["port"]
    _, _, valid, film = port.geo_tracer(jax_design["probe"])
    assert valid.all() and jax_design["probe_valid"].all()
    np.testing.assert_allclose(film[1:].numpy(), jax_design["probe_film"][1:],
                               atol=1e-5)
    cam = port.sources[0].camera_pos
    assert np.allclose(cam[:2], film.numpy().mean(0)[:2])


@pytest.mark.parametrize("point", [0, 1])
def test_loss_and_gradients_match_jax(jax_design, point):
    port = jax_design["port"]
    p = {k: torch.tensor(v) for k, v in jax_design["points"][point].items()}
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss = port.loss(leaves, point)
    loss.backward()
    want = jax_design["values"][point]
    loss = float(loss.detach())
    assert abs(loss - want) <= 1e-4 * abs(want), (loss, want)
    for k, g in jax_design["grads"][point].items():
        got = leaves[k].grad.numpy()
        assert np.isfinite(got).all(), k
        if np.linalg.norm(g) > 1e-3 * abs(want):
            assert _rel(got, g) < 1e-3, (k, got, g)
        else:   # K at a spherical surface: no gradient to speak of
            assert np.abs(got - g).max() < 1e-3 * abs(want), (k, got, g)


def test_two_adam_steps_match_jax(jax_design):
    port = jax_design["port"]
    ls = port.lens_system
    p = port.optimize()
    port.lens_system = ls
    assert len(port.loss_history) == 2
    np.testing.assert_allclose(port.loss_history, jax_design["values"],
                               rtol=1e-4)
    for k, want in jax_design["final"].items():
        np.testing.assert_allclose(p[k].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, abs(float(want))))


def test_dispersion_gradient_only_when_spectral(jax_design):
    """The Abbe numbers reach the loss through the hero wavelengths only
    (cauchy_from_abbe pins n(589.3 nm) = n_d), as
    tests/test_lens_design.py holds the JAX package."""
    port = jax_design["port"]
    g = {}
    for spectral in (True, False):
        port.integrator.spectral = spectral
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in port.params().items()}
        port.loss(leaves, 0).backward()
        g[spectral] = float(leaves["mat_sf11_V_d"].grad)
    port.integrator.spectral = True
    assert np.isfinite(g[True]) and abs(g[True]) > 50.0 * max(
        abs(g[False]), 1e-12), g


@pytest.mark.slow
def test_gradient_matches_central_differences():
    """tests/test_lens_design.py ``test_design_gradient_matches_fd`` on the
    port: a defocused singlet, 24x24 x 128 light paths through a
    10-degree sensor, the rear curvature's gradient against central
    differences of the loss at the same seed, within 10 %."""
    glass = LensMaterial.create("nbk7", ior=1.5168, V_d=64.17)
    surfs = [ConicSurface.create(8.0, -1.0 / 24.0, 0.0, 20.0, device="cpu"),
             ConicSurface.create(8.0, 1.0 / 24.0, 0.0, 24.0, device="cpu")]
    ls = LensSystem.create(surfs, [glass], n_rings=8, n_sectors=16)
    dp = DesignProblem(ls, resolution=(24, 24), spp=128, iters=1,
                       sensor_fov=10.0).build()
    p = {k: v.detach().clone() for k, v in dp.params().items()}
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    dp.loss(leaves, 0).backward()
    eps = 2e-3
    with torch.no_grad():
        hi = dp.loss({**p, "lens0_c": p["lens0_c"] + eps}, 0)
        lo = dp.loss({**p, "lens0_c": p["lens0_c"] - eps}, 0)
    fd = float(hi - lo) / (2 * eps)
    ad = float(leaves["lens0_c"].grad)
    assert abs(ad - fd) < 0.1 * abs(fd) + 1e-3, (ad, fd)


@pytest.mark.parametrize("which", ["doublet", "triplet"])
def test_paraxial_matches_jax(which):
    ls = _jax_doublet() if which == "doublet" else _jax_triplet()
    port, _ = lens_from_numpy(export_lens(ls), device="cpu")
    for name in ("compute_EFL", "compute_BFL", "compute_FFL"):
        want = float(getattr(ls, name)())
        assert abs(float(getattr(port, name)()) - want) <= 1e-5 * abs(want)
    for a, b in zip(port.compute_pupils(), ls.compute_pupils()):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)) + 1e-6
    for k, v in ls.rear_surface_params_for_EFL(40.0).items():
        got = float(port.rear_surface_params_for_EFL(40.0)[k])
        assert abs(got - float(v)) <= 1e-5 * abs(float(v)), k
    np.testing.assert_allclose(
        port.trace_paraxial_front2film(torch.tensor([0.1, 0.0])).numpy(),
        np.asarray(ls.trace_paraxial_front2film(jnp.asarray([0.1, 0.0]))),
        rtol=1e-5, atol=1e-7)


def test_remesh_matches_jax(jax_design):
    """Vertices and sag normals after a parameter change, on the doublet's
    scene meshes, and an even asphere's sag and normals."""
    port = jax_design["port"]
    got = port.apply_params({k: torch.tensor(v) for k, v in STEP.items()}) \
        .remesh(list(port.base_scene.meshes), port.templates, mesh_offset=1)
    verts, normals = jax_design["remeshed"]
    for m, v, n in zip(got, verts, normals):
        np.testing.assert_allclose(m.vertices.detach().numpy(), v, rtol=1e-6,
                                   atol=1e-6)
        if n is not None:
            np.testing.assert_allclose(m.normals.detach().numpy(), n,
                                       atol=1e-6)
    ps = EvenAsphericSurface.create(**ASPHERE, device="cpu")
    xy = torch.tensor(ASPHERE_XY)
    sag, normals = jax_design["asphere"]
    np.testing.assert_allclose(ps.sag(xy[:, 0], xy[:, 1]).numpy(), sag,
                               rtol=1e-6)
    np.testing.assert_allclose(_sag_normals(ps, xy).numpy(), normals,
                               atol=1e-6)


def test_normals_carry_the_surface_gradient():
    """The sag normals stay in the graph of the surface's parameters."""
    port_ls, _ = lens_from_numpy(export_lens(_jax_doublet()), device="cpu")
    s = port_ls.surfaces[1]
    c = s.c.clone().requires_grad_()
    xy = torch.tensor([[1.0, 2.0], [3.0, -1.0]])
    n = _sag_normals(s.with_params({"c": c}), xy)
    (g,) = torch.autograd.grad(n[:, 0].sum(), c)
    assert torch.isfinite(g) and float(g) != 0.0


def test_triplet_remesh_refits_the_bvh():
    """The triplet's scene (1,730 faces) walks a BVH; after a remesh its
    hits equal a fresh build's: the tree is refitted at the render."""
    port_ls, _ = lens_from_numpy(export_lens(_jax_triplet()), device="cpu")
    dp = DesignProblem(port_ls, resolution=(4, 4), spp=1, num_sources=1,
                       sensor_fov=10.0)
    dp.build()
    assert dp.base_scene.accel is not None
    scene, _ = dp.scene_for({"lens3_z0": torch.tensor(51.5),
                             "lens2_c": torch.tensor(0.3)}, 0)
    o = torch.zeros((256, 3))
    o[:, 0] = torch.linspace(-4.5, 4.5, 256)
    o[:, 2] = 80.0
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(256, 3).contiguous()
    from mitsuba_tpu_torch.core.records import Ray
    ray = Ray(o=o, d=d, maxt=torch.full((256,), float("inf")))
    act = torch.ones(256, dtype=torch.bool)
    got = scene.ray_intersect_preliminary(ray, act, scene.trace_ctx())
    fresh = refresh_accel(scene)
    want = fresh.ray_intersect_preliminary(ray, act, fresh.trace_ctx())
    assert torch.equal(got.prim_index, want.prim_index)
    assert torch.allclose(got.t, want.t, rtol=1e-6)
    v = scene.geometry()[0]
    tree = refit_bvh(scene.accel, v)
    assert not torch.equal(tree.bbox_lo, dp.base_scene.accel.bbox_lo)


def _fns(calls, bad_seeds=None, bad_value_only=None):
    """Per-sensor (value, gradient) functions recording their seeds:
    sensor i returns 1 + i and gradient i + 1, NaN on the seeds of
    ``bad_seeds[i]`` (or, with ``bad_value_only``, a NaN value beside a
    finite gradient)."""
    def mk(si):
        def fn(p, seed):
            calls[si].append(int(seed))
            bad = int(seed) in (bad_seeds or {}).get(si, ())
            nan_v = bad or int(seed) in (bad_value_only or {}).get(si, ())
            v = torch.tensor(float("nan") if nan_v else 1.0 + si)
            g = {"c": torch.full((2,), float("nan") if bad else si + 1.0)}
            return v, g
        return fn
    return [mk(si) for si in range(len(calls))]


def test_accumulate_sensor_grads_resamples_before_dropping():
    """tests/test_lens_design.py's case: a sensor non-finite on the base
    seed is redrawn with a decorrelated seed, and dropped only when every
    redraw fails."""
    calls = {0: [], 1: [], 2: []}
    fns = _fns(calls, bad_seeds={1: (7,), 2: range(10 ** 7)})
    val, g, used = accumulate_sensor_grads(fns, {"c": torch.zeros(2)}, 7,
                                           retries=2)
    assert used == [True, True, False]
    assert torch.allclose(g["c"], torch.tensor(3.0))
    assert float(val) == pytest.approx(3.0)
    assert calls[0] == [7]
    assert len(calls[1]) == 2 and calls[1][0] == 7 and calls[1][1] != 7
    assert len(calls[2]) == 3 and calls[1][1] != calls[2][1]
    calls = {0: []}
    val, g, used = accumulate_sensor_grads(
        _fns(calls, bad_seeds={0: range(10 ** 7)}), {"c": torch.zeros(2)},
        7, retries=1)
    assert g is None and used == [False]


def test_non_finite_loss_is_redrawn():
    """The repaired fault: the JAX package keeps a draw whose gradient is
    finite and whose loss is not; the port redraws it."""
    calls = {0: [], 1: []}
    fns = _fns(calls, bad_value_only={1: (7,)})
    val, g, used = accumulate_sensor_grads(fns, {"c": torch.zeros(2)}, 7)
    assert used == [True, True] and len(calls[1]) == 2
    assert np.isfinite(float(val))


def test_nan_guard_step_skips():
    opt = Adam(lr=0.1)
    p = {"a": torch.ones(2)}
    state = opt.init(p)
    p2, s2, ok = nan_guard_step(opt, p, {"a": torch.tensor([1.0, np.nan])},
                                state)
    assert not ok and p2 is p and s2 is state
    p3, _, ok = nan_guard_step(opt, p, {"a": torch.ones(2)}, state)
    assert ok and not torch.equal(p3["a"], p["a"])


def test_checkpointed_loop_resumes(tmp_path):
    """A loop killed after step 3 resumes at step 4 with the saved
    parameters, optimizer state and extra arrays; ``.best`` keeps the
    lowest metric's."""
    path = str(tmp_path / "ck")
    opt = Adam(lr=0.1)
    p = {"a": torch.zeros(3)}
    state = opt.init(p)
    loop = CheckpointedLoop(path, every=2)
    metrics = [5.0, 2.0, 3.0, 4.0]
    for it, m in enumerate(metrics):
        p, state = opt.step(p, {"a": torch.ones(3)}, state)
        loop.maybe_save(it, p, state, metric=m,
                        extra={"drops": np.array([it, 1])})
    fresh = Adam(lr=0.1).init({"a": torch.zeros(3)})
    like = {"drops": np.zeros(2, np.int64)}
    again = CheckpointedLoop(path, every=2)
    q, s, start = again.resume({"a": torch.zeros(3)}, fresh, extra=like)
    assert start == 4 and torch.equal(q["a"], p["a"])
    assert int(s["t"]) == 4 and torch.equal(s["m"]["a"], state["m"]["a"])
    assert again.extra["drops"].tolist() == [3, 1]
    best = CheckpointedLoop(path + ".best")
    q, _, start = best.resume({"a": torch.zeros(3)}, fresh, extra=like)
    assert start == 2 and best.extra["drops"].tolist() == [1, 1]
    none = CheckpointedLoop(str(tmp_path / "missing"))
    assert none.resume(p, state)[2] == 0


def test_sensor_drops_survive_a_resume(jax_design, tmp_path, monkeypatch):
    """The repaired fault: the JAX package resets ``sensor_drops`` on a
    resume; the port restores them from the checkpoint.  Sensor 1 of a
    two-source problem is made to fail every draw (a NaN loss)."""
    port_ls = jax_design["port"].lens_system
    path = str(tmp_path / "design")

    def run(iters):
        dp = DesignProblem(port_ls, resolution=(4, 4), spp=2, iters=iters,
                           num_sources=2, max_field_angle=2.0,
                           sensor_fov=10.0, grad_retries=1).build()
        real = dp.sensor_loss

        def sensor_loss(p, seed, si):
            if si == 1:
                return p["lens2_z0"] * float("nan")
            return real(p, seed, si)

        monkeypatch.setattr(dp, "sensor_loss", sensor_loss)
        dp.optimize(checkpoint_path=path, checkpoint_every=1)
        return dp

    assert run(2).sensor_drops == [0, 2]
    assert run(3).sensor_drops == [0, 3]
