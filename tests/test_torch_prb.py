"""Differentiable rendering in the port against mitsuba_tpu, on the CPU:
PRB gradients, the forward mode, the basic PRB integrator and its lens
tracer, scene parameters and the optimizers.

The JAX gradients are computed once for the module (``jax_prb``): one
``jax.vjp`` of ``prb_render`` on an 8x8 Cornell box with a 16x16x3
bitmap on its back wall, at 4 / 4 spp and depth 3, for every float leaf
at once; most of this file's time is that one JAX backward's compile.
The port must give the primal image within rtol 1e-5, atol 1e-6 (the
bar of tests/test_prb.py ``test_prb_primal_matches_path``) and each
gradient within 1e-3 of JAX's in relative norm.  The other cases are
tests/test_prb.py's, held by its bars on the port alone (central finite
differences at the same seed within 5 %, the Adam recovery, SGD, the
forward mode against the backward one), at sizes a little smaller.
"""
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.models.bsdfs as jbsdfs
import mitsuba_tpu.models.textures as jtextures
from mitsuba_tpu.core.records import Ray as JRay
from mitsuba_tpu.core.transform import compose as jcompose
from mitsuba_tpu.core.transform import rotate as jrotate
from mitsuba_tpu.core.transform import scale as jscale
from mitsuba_tpu.core.transform import translate as jtranslate
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.models.integrators.prb import PRBIntegrator as JPRB
from mitsuba_tpu.models.integrators.prb import prb_render as jprb_render
from mitsuba_tpu.models.integrators.prb_basic import (
    PRBBasicIntegrator as JPRBBasic)
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.models.shapes import Mesh as JMesh
from mitsuba_tpu.models.shapes import rectangle as jrectangle
from mitsuba_tpu.utils import optimizers as joptim
from mitsuba_tpu.utils.params import traverse as jtraverse
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
from mitsuba_tpu_torch import (PathIntegrator, PRBBasicIntegrator,
                               PRBIntegrator, big_scene, cornell_box,
                               prb_render, prb_render_forward, render,
                               sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.models.integrators.prb import _nee_geometry_attached
from mitsuba_tpu_torch.utils import optimizers
from mitsuba_tpu_torch.utils.params import (SceneParameters, float_leaves,
                                            refresh_accel, traverse, update)
from mitsuba_tpu_torch.utils.scenes import checker_bitmap
from torch_parity import export_scene

SEED, SPP, DEPTH = 0, 4, 3
ALBEDO = "bsdfs.0.reflectance.value"
GRAD_LEAVES = {
    "albedo": r"^bsdfs\.[0-2]\.reflectance\.value$",
    "texels": r"^bsdfs\.3\.reflectance\.data$",
    "radiance": r"^emitters\.0\.radiance\.value$",
    "vertices": r"^meshes\.6\.vertices$",
    "sensor": r"^sensor\.to_world$",
}


def _jax_textured_cornell():
    """The JAX Cornell box at 8x8, its back wall a 16x16x3 bilinear bitmap
    made from the seed, tiled 3x3 (uvs scaled by 3)."""
    base = jcornell_box(width=8, height=8)
    meshes = list(base.meshes)
    meshes[3] = meshes[3].replace(uvs=meshes[3].uvs * 3.0,
                                  bsdf_index=len(base.bsdfs))
    bitmap = jbsdfs.SmoothDiffuse(jtextures.BitmapTexture(
        data=jnp.asarray(checker_bitmap(16, 16, 3, 3, cells=4))))
    return jmake_scene(meshes, list(base.bsdfs) + [bitmap],
                       list(base.emitters), base.sensor, use_bvh=False)


def _weights(shape):
    """The loss's per-pixel weights, made from the seed."""
    return np.random.default_rng(11).uniform(0.5, 1.5, shape).astype(
        np.float32)


MODES = ("attach", "follow_shape", "detach_shape")
SI_KEY = "meshes.6.vertices"   # the small box


@pytest.fixture(scope="module")
def jax_prb():
    """Every JAX reference of this file's scene in one jitted program (a
    quarter of the eager calls' compile time): the PRB image and the
    gradients of a weighted sum of it for every float leaf; the basic
    PRB estimate on the primary rays; their preliminary intersections,
    ``compute_si`` in each mode with the gradient of a weighted sum of p
    with respect to the small box's vertices; NEE samples from the hits
    with their attached radiance and pdf.  Also the port's PRB image and
    gradients on the same arrays."""
    from mitsuba_tpu.utils.params import update as jupdate

    jscene = _jax_textured_cornell()
    w = _weights((8, 8, 3))
    w_si = jnp.asarray(_weights((8 * 8 * SPP, 3)))
    r = np.random.default_rng(2)
    s1 = jnp.asarray(r.random(8 * 8 * SPP, np.float32))
    s2 = jnp.asarray(r.random((8 * 8 * SPP, 2), np.float32))
    integ = JPRB(max_depth=DEPTH, rr_depth=16)

    @jax.jit
    def references(sc, cotangent, v0):
        img, vjp = jax.vjp(
            lambda s: jprb_render(s, integ, SEED, SPP, SPP), sc)
        out = {"image": img, "grads": vjp(cotangent)[0]}
        ray, _, _, lane = jsample_rays(sc, jnp.uint32(SEED), SPP)
        active = jnp.ones(lane.shape, bool)
        out["basic"] = JPRBBasic(max_depth=DEPTH).sample(
            sc, ray, lane, jnp.uint32(SEED), active)
        pi = sc.ray_intersect_preliminary(ray, active)
        out["ray"], out["pi"] = ray, pi
        for mode in MODES:
            def loss(v, mode=mode):
                si = jupdate(sc, {SI_KEY: v}).compute_si(pi, ray, mode=mode)
                return jnp.sum(si.p * w_si), si
            (_, si), g = jax.value_and_grad(loss, has_aux=True)(v0)
            out[mode] = (si, g)
        si = sc.compute_si(pi, ray)
        ds, _, ok = sc.sample_emitter_direction(si, s1, s2, si.is_valid())
        out["nee"] = (si.p, ds, ok, sc.eval_emitter_direction(si, ds, ok),
                      sc.pdf_emitter_direction(si.p, ds, ok))
        return out

    refs = jax.tree_util.tree_map(np.array, references(
        jscene, jnp.asarray(w), jtraverse(jscene)[SI_KEY]))
    jgrads = {k: v for k, v in jtraverse(refs.pop("grads")).items()
              if v.dtype == np.float32}

    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    leaves = {k: v.clone().requires_grad_()
              for k, v in float_leaves(scene).items()}
    img = prb_render(update(scene, leaves), PRBIntegrator(DEPTH, 16), SEED,
                     SPP, SPP, device="cpu")
    torch.sum(img * torch.from_numpy(w)).backward()
    return SimpleNamespace(
        jimg=refs.pop("image"), jgrads=jgrads, img=img.detach().numpy(),
        grads={k: v.grad for k, v in leaves.items()}, jscene=jscene,
        scene=scene, refs=refs, w_si=np.array(w_si))


def test_prb_primal_matches_jax(jax_prb):
    np.testing.assert_allclose(jax_prb.img, jax_prb.jimg, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("group", sorted(GRAD_LEAVES))
def test_prb_gradients_match_jax(jax_prb, group):
    jgrads, grads = jax_prb.jgrads, jax_prb.grads
    keys = [k for k in grads if re.search(GRAD_LEAVES[group], k)]
    assert keys
    for k in keys:
        got, want = grads[k].numpy(), jgrads[k]
        assert np.isfinite(got).all(), k
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert np.linalg.norm(want) > 0 and err <= 1e-3, (k, err)


def test_prb_gradients_finite(jax_prb):
    bad = [k for k, g in jax_prb.grads.items() if g is None
           or not bool(torch.isfinite(g).all())]
    assert not bad, bad


def test_traverse_paths_match_jax(jax_prb):
    """The port's parameter paths are the JAX package's: every port leaf
    has the JAX leaf of the same path and value, and the JAX float leaves
    the port lacks are its detached precomputations; a JAX dict taken to
    numpy applies to the port's scene unchanged."""
    scene = jax_prb.scene
    jparams = {k: np.asarray(v) for k, v in jtraverse(jax_prb.jscene).items()}
    params = traverse(scene)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), jparams[k].astype(
            v.numpy().dtype))
    missing = {k.split(".")[0] for k, v in jparams.items()
               if k not in params and v.dtype == np.float32}
    assert missing == {"face_distrs", "emitter_distr", "scene_center",
                       "scene_radius"}, missing
    for k in GRAD_LEAVES.values():
        assert any(re.search(k, p) for p in params), k
    same = update(scene, jparams)
    for k, v in traverse(same).items():
        np.testing.assert_array_equal(v.numpy(), params[k].numpy())
    assert same.face_distrs is scene.face_distrs
    moved = {k: v + 0.25 for k, v in jparams.items() if k.startswith("bsdfs")}
    sc = update(scene, moved)
    np.testing.assert_array_equal(
        traverse(sc)["bsdfs.3.reflectance.data"].numpy(),
        moved["bsdfs.3.reflectance.data"])
    assert sc.meshes is scene.meshes   # unchanged subtrees are shared
    # SceneParameters: keep, apply
    p = SceneParameters(scene).keep(r"reflectance\.value$")
    assert sorted(p) == [f"bsdfs.{i}.reflectance.value" for i in range(3)]
    p[ALBEDO] = torch.zeros(3)
    assert float(p.apply().bsdfs[0].reflectance.value.sum()) == 0.0
    assert refresh_accel(scene) is scene   # no BVH below MAX_FACES


def _with_albedo(scene, a, i=0):
    return update(scene, {f"bsdfs.{i}.reflectance.value": a})


def _with_radiance(scene, r):
    return update(scene, {"emitters.0.radiance.value": r})


def _grad_and_fd(scene, put, x0, index, eps, integ, spp=16):
    """d mean(image) / d x[index] by PRB and by central differences at
    the same seed."""
    def loss(x):
        return prb_render(put(scene, x), integ, SEED, spp, spp,
                          device="cpu").mean()

    x = x0.clone().requires_grad_()
    loss(x).backward()
    step = torch.zeros_like(x0)
    step[index] = eps
    with torch.no_grad():
        fd = (loss(x0 + step) - loss(x0 - step)) / (2 * eps)
    return float(x.grad[index]), float(fd)


@pytest.mark.parametrize("case", ["albedo", "emitter", "deep"])
def test_prb_grad_vs_fd(case):
    """tests/test_prb.py's three finite-difference cases at 8x8 x 16 spp:
    the white albedo (depth 3), the light's radiance (depth 3) and the
    albedo through the Lr_ind ratio of deeper bounces (depth 6, 8 spp)."""
    scene = cornell_box(8, 8, device="cpu")
    if case == "emitter":
        g, fd = _grad_and_fd(scene, _with_radiance,
                             torch.tensor([18.387, 13.9873, 6.75357]), 0,
                             0.2, PRBIntegrator(3, 16))
    elif case == "albedo":
        g, fd = _grad_and_fd(scene, _with_albedo, torch.full((3,), 0.6), 0,
                             5e-3, PRBIntegrator(3, 16))
    else:
        g, fd = _grad_and_fd(scene, _with_albedo, torch.full((3,), 0.75), 1,
                             5e-3, PRBIntegrator(6, 16), spp=8)
    assert abs(g - fd) < 0.05 * abs(fd), (g, fd)


def test_texel_grad_vs_fd(jax_prb):
    """Three texels of the back wall's bitmap, those of the largest
    gradients of sum(image): PRB against central differences."""
    scene = jax_prb.scene
    integ = PRBIntegrator(DEPTH, 16)
    key = "bsdfs.3.reflectance.data"
    data = traverse(scene)[key]

    def loss(x):
        return prb_render(update(scene, {key: x}), integ, SEED, SPP, SPP,
                          device="cpu").sum()

    x = data.clone().requires_grad_()
    loss(x).backward()
    top = torch.topk(x.grad.abs().flatten(), 3).indices
    eps = 0.05
    for i in top.tolist():
        step = torch.zeros(data.numel())
        step[i] = eps
        step = step.reshape(data.shape)
        with torch.no_grad():
            fd = float(loss(data + step) - loss(data - step)) / (2 * eps)
        g = float(x.grad.flatten()[i])
        assert abs(g - fd) < 0.05 * abs(fd), (i, g, fd)


@pytest.mark.parametrize("mode", MODES)
def test_compute_si_modes_match_jax(mode, jax_prb):
    """Scene.compute_si in each differentiability mode on the same
    preliminary intersections as JAX's: the interaction's p, t and uv,
    and the gradient of a weighted sum of p with respect to the small
    box's vertices (none through ``detach_shape``), within 1e-6 of its
    largest entry."""
    from mitsuba_tpu_torch.core.records import PreliminaryIntersection

    out, scene, w = jax_prb.refs, jax_prb.scene, jax_prb.w_si
    jpi, jray = out["pi"], out["ray"]
    jsi, jg = out[mode]
    pi = PreliminaryIntersection(
        t=torch.from_numpy(jpi.t),
        prim_index=torch.from_numpy(jpi.prim_index).long(),
        prim_uv=torch.from_numpy(jpi.prim_uv),
        shape_index=torch.from_numpy(jpi.shape_index).long())
    ray = Ray(o=torch.from_numpy(jray.o), d=torch.from_numpy(jray.d),
              maxt=torch.from_numpy(jray.maxt))
    v = traverse(scene)[SI_KEY].clone().requires_grad_()
    si = update(scene, {SI_KEY: v}).compute_si(pi, ray, mode=mode)
    for name in ("p", "t", "uv"):
        np.testing.assert_allclose(getattr(si, name).detach().numpy(),
                                   getattr(jsi, name), rtol=1e-6, atol=1e-6)
    loss = torch.sum(si.p * torch.from_numpy(w))
    if mode == "detach_shape":
        assert not loss.requires_grad and not jg.any()
        return
    loss.backward()
    scale = np.abs(jg).max()   # XLA's fused program rounds near-zeros apart
    assert scale > 0
    np.testing.assert_allclose(v.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-6 * scale)


def test_emitter_direction_matches_jax(jax_prb):
    """Scene.eval_emitter_direction (AreaEmitter.eval_direction under it)
    and pdf_emitter_direction on the JAX package's NEE samples from the
    Cornell box's primary hits: equal to JAX's within 1e-6."""
    from mitsuba_tpu_torch.core.records import DirectionSample

    p, jds, ok, *want = jax_prb.refs["nee"]
    ds = DirectionSample(**{f: torch.from_numpy(getattr(jds, f)) for f in (
        "p", "n", "uv", "d", "dist", "pdf", "delta")},
        emitter_index=torch.from_numpy(jds.emitter_index).long())
    si = SimpleNamespace(p=torch.from_numpy(p))
    ok = torch.from_numpy(ok)
    got = (jax_prb.scene.eval_emitter_direction(si, ds, ok),
           jax_prb.scene.pdf_emitter_direction(si.p, ds, ok))
    assert bool(ok.any()) and np.abs(want[0]).max() > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_prb_primal_matches_path():
    """prb's primal estimate equals the plain path tracer's."""
    scene = cornell_box(8, 8, device="cpu")
    a = render(scene, PathIntegrator(max_depth=3, rr_depth=16), seed=0,
               spp=8, device="cpu")
    b = prb_render(scene, PRBIntegrator(max_depth=3, rr_depth=16), 0, 8, 8,
                   device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_prb_gradient_reaches_user_tensor():
    """A parameter that feeds the scene through the caller's own
    operations (the albedo is 2 * a) gets its gradient through them."""
    scene = cornell_box(8, 8, device="cpu")
    integ = PRBIntegrator(3, 16)
    a = torch.full((3,), 0.3, requires_grad=True)
    prb_render(_with_albedo(scene, 2 * a), integ, 0, 2, device="cpu") \
        .mean().backward()
    b = torch.full((3,), 0.6, requires_grad=True)
    prb_render(_with_albedo(scene, b), integ, 0, 2, device="cpu") \
        .mean().backward()
    torch.testing.assert_close(a.grad, 2 * b.grad)


def test_prb_render_needs_a_device_choice():
    """Without device="cpu", prb_render runs on the GPU: here, with a CPU
    scene, it raises (no GPU, or a scene on another device)."""
    scene = cornell_box(8, 8, device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        prb_render(scene, PRBIntegrator(3, 16), 0, 2)


def test_adam_albedo_recovery():
    """Inverse rendering: recover the white-wall albedo from a target
    rendered at the same seed and spp (BASELINE config 3 scaled down;
    tests/test_prb.py's bars)."""
    scene = cornell_box(8, 8, device="cpu")
    integ = PRBIntegrator(max_depth=3, rr_depth=16)
    a_true = torch.tensor([0.8, 0.3, 0.5])
    target = prb_render(_with_albedo(scene, a_true), integ, 0, 4, 4,
                        device="cpu")

    def loss(a):
        img = prb_render(_with_albedo(scene, a), integ, 0, 4, 4, device="cpu")
        return torch.mean((img - target) ** 2)

    opt = optimizers.Adam(lr=0.05)
    params = {"a": torch.tensor([0.4, 0.6, 0.2])}
    state = opt.init(params)
    with torch.no_grad():
        l0 = float(loss(params["a"]))
    for _ in range(60):
        a = params["a"].clone().requires_grad_()
        loss(a).backward()
        params, state = opt.step(params, {"a": a.grad}, state)
        params["a"] = params["a"].clamp(0.0, 1.0)
    with torch.no_grad():
        l1 = float(loss(params["a"]))
    assert l1 < 0.02 * l0, (l0, l1)
    np.testing.assert_allclose(params["a"].numpy(), a_true.numpy(), atol=0.05)


def test_sgd_momentum_descends():
    opt = optimizers.SGD(lr=0.1, momentum=0.9)
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(200):
        x = params["x"].clone().requires_grad_()
        torch.sum((x - 3.0) ** 2).backward()
        params, state = opt.step(params, {"x": x.grad}, state)
    np.testing.assert_allclose(params["x"].numpy(), 3.0, atol=0.05)


@pytest.mark.parametrize("kind", ["adam", "adam_mask_uniform", "sgd",
                                  "sgd_momentum_mask"])
def test_optimizer_step_matches_jax(kind):
    """Three steps of the JAX optimizer and the port's on the same seeded
    parameters, gradients (some exactly 0) and state, the state carried
    across from numpy: equal within 1e-6."""
    r = np.random.default_rng(3)
    shapes = {"a": (3,), "b": (4, 5)}
    params = {k: r.uniform(-1, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * (r.uniform(size=s) > 0.3)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(3)]
    kw = {"adam": ("Adam", dict(lr=0.05)),
          "adam_mask_uniform": ("Adam", dict(lr=0.02, mask_updates=True,
                                             uniform=True)),
          "sgd": ("SGD", dict(lr=0.1)),
          "sgd_momentum_mask": ("SGD", dict(lr=0.1, momentum=0.9,
                                            mask_updates=True))}[kind]
    jopt = getattr(joptim, kw[0])(**kw[1])
    topt = getattr(optimizers, kw[0])(**kw[1])
    jopt.set_learning_rate({"b": 0.03})
    topt.set_learning_rate({"b": 0.03})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                jopt.init(jp))
    for g in grads:
        jp, js = jopt.step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_prb_forward_mode_matches_backward():
    """<grad, tangent> equals d mean(image) along the tangent from
    prb_render_forward (tests/test_prb.py's bar, 5 %)."""
    scene = cornell_box(8, 8, device="cpu")
    integ = PRBIntegrator(max_depth=3, rr_depth=16)
    a = torch.full((3,), 0.6, requires_grad=True)
    prb_render(_with_albedo(scene, a), integ, 0, SPP, SPP,
               device="cpu").mean().backward()
    expect = float(a.grad[0])
    base = _with_albedo(scene, torch.full((3,), 0.6))
    img, dimg = prb_render_forward(base, {ALBEDO: torch.tensor([1.0, 0, 0])},
                                   integ, seed=0, spp=SPP, device="cpu")
    got = float(dimg.mean())
    assert abs(got - expect) < 0.05 * max(abs(expect), 1e-4), (got, expect)
    np.testing.assert_array_equal(
        img.numpy(), prb_render(base, integ, 0, SPP, device="cpu").numpy())


def test_prb_bvh_scene_grad_vs_fd():
    """A PRB step on the 1,316-face BVH scene (the plain BVH walks): the
    white albedo's gradient against central differences."""
    scene = big_scene(8, 8, subdiv=3, device="cpu")
    assert scene.accel is not None
    moved = refresh_accel(update(scene, {"meshes.8.vertices": traverse(
        scene)["meshes.8.vertices"] + 0.01}))
    assert not torch.equal(moved.accel.bbox_hi, scene.accel.bbox_hi)
    g, fd = _grad_and_fd(scene, _with_albedo, torch.full((3,), 0.6), 0,
                         5e-3, PRBIntegrator(3, 16), spp=4)
    assert abs(g - fd) < 0.05 * abs(fd), (g, fd)


def test_nee_geometry_masked_lanes_finite():
    """_nee_geometry_attached on masked lanes: a sample on the shading
    point (r = 0), at infinity (dist 1e8) and without a normal give jac = 1
    and finite gradients."""
    from mitsuba_tpu_torch.core.records import DirectionSample
    p = torch.tensor([[0.0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                     requires_grad=True)
    ds_p = torch.tensor([[0.0, 0, 0], [0, 0, 1e8], [0, 0, 1], [0, 0, 2]])
    n = torch.tensor([[0.0, 0, -1], [0, 0, -1], [0, 0, 0], [0, 0, -1]])
    ds = DirectionSample(p=ds_p, n=n, uv=torch.zeros(4, 2),
                         d=torch.tensor([[0.0, 0, 1]] * 4),
                         dist=torch.tensor([0.0, 1e8, 1, 2]),
                         pdf=torch.ones(4), delta=torch.zeros(4, dtype=bool),
                         emitter_index=torch.zeros(4, dtype=torch.int64))
    si = type("SI", (), {"p": p})()
    d, jac = _nee_geometry_attached(si, ds, torch.ones(4, dtype=torch.bool))
    torch.testing.assert_close(jac.detach(), torch.ones(4))
    (d.sum() + jac.sum()).backward()
    assert torch.isfinite(p.grad).all()


@pytest.fixture(scope="module")
def lens_scenes():
    """A glass slab (two dielectric rectangles at z = 1 and z = 0.5,
    facing out) over a diffuse film at z = 0, under the Cornell box's
    light, in JAX and in the port."""
    base = jcornell_box(width=8, height=8)
    T = jcompose

    def mesh(to_world, bsdf):
        v, f, _, uv = jrectangle(np.asarray(to_world))
        return JMesh.make(v, f, uvs=uv, bsdf_index=bsdf)

    meshes = [base.meshes[0],
              mesh(T(jtranslate([0, 0, 1.0]), jscale(0.6)), 3),
              mesh(T(jtranslate([0, 0, 0.5]), jrotate([1, 0, 0], 180),
                     jscale(0.6)), 3),
              mesh(T(jscale(2.0)), 0)]
    bsdfs = list(base.bsdfs) + [jbsdfs.SmoothDielectric(eta=jnp.float32(1.5))]
    jscene = jmake_scene(meshes, bsdfs, list(base.emitters), base.sensor,
                         use_bvh=False)
    r = np.random.default_rng(4)
    o = np.concatenate([r.uniform(-0.4, 0.4, (64, 2)), np.full((64, 1), 2.0)],
                       1).astype(np.float32)
    d = np.concatenate([r.uniform(-0.2, 0.2, (64, 2)), -np.ones((64, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (jscene, scene_from_numpy(export_scene(jscene), device="cpu"),
            o, d)


@pytest.mark.parametrize("what", ["sample", "trace"])
def test_prb_basic_matches_jax(what, lens_scenes, jax_prb):
    """PRBBasicIntegrator.sample on the textured Cornell box (8x8 x 4 spp,
    depth 3) and its forced-transmission trace through the slab (the
    rays that miss the slab are invalid in both), against JAX within
    1e-5."""
    if what == "sample":
        scene, want = jax_prb.scene, jax_prb.refs["basic"]
        ray, _, _, lane = sample_rays(scene, SEED, SPP)
        got = PRBBasicIntegrator(max_depth=DEPTH).sample(
            scene, ray, lane, SEED, torch.ones(lane.shape, dtype=torch.bool))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        return
    jscene, scene, o, d = lens_scenes
    want = jax.jit(lambda sc, o, d: JPRBBasic().trace(sc, JRay.make(o, d), 3))(
        jscene, jnp.asarray(o), jnp.asarray(d))
    got = PRBBasicIntegrator().trace(
        scene, Ray(o=torch.from_numpy(o), d=torch.from_numpy(d),
                   maxt=torch.full((64,), float("inf"))), 3)
    assert got[2].float().mean() > 0.9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
