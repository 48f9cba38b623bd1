"""The shadow-boundary term of the port against mitsuba_tpu, on the CPU:
the ``OcSpaceDistr`` octree, the silhouette projection (``projection.py``),
``_indirect_pass`` lane by lane at depth 1 and 2, ``indirect_boundary_grads``
under its octree and projective guides, and what ``prb_projective_render``
adds with the term on.

The scenes are tests/test_projective.py's ``_shadow_scene`` (a blocker
outside the view whose shadow alone is seen) and ``_probe_panel_scene`` (a
panel lit only by the floor's bounce), and tests/test_projection.py's
smooth sphere under one light, each carried across by ``export_scene``.
The JAX references are computed once for the module (``jax_refs``), each
pass jitted on its own: the JAX package's ``_indirect_pass`` and
``project_seed_points`` are replaced by jitted twins while its own
``indirect_boundary_grads`` runs, and the
scenes' radius is held static (``_static_radius``) so that the depth-k
pass, which reads it as a Python float, traces.  Gradients must agree
within 1e-3 in relative norm a leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.models.integrators import PathProjectiveIntegrator as JPPI
from mitsuba_tpu.models.integrators import projection as jprojection
from mitsuba_tpu.models.integrators import projective as jproj
from mitsuba_tpu.models.integrators.guiding import OcSpaceDistr as JOcSpace
from mitsuba_tpu.models.integrators.prb import _float_partition
from mitsuba_tpu.models.scene import Scene as JScene
from mitsuba_tpu.models.sensors import PerspectiveCamera as JCamera
from mitsuba_tpu.utils.params import traverse as jtraverse
from mitsuba_tpu_torch import (DirectProjectiveIntegrator, OcSpaceDistr,
                               PathIntegrator, PathProjectiveIntegrator,
                               build_face_adjacency, build_silhouette_edges,
                               hybrid_projection, indirect_boundary_grads,
                               mesh_walk, prb_projective_render,
                               project_seed_points, render, scene_from_numpy)
from mitsuba_tpu_torch.models.integrators import projective
from mitsuba_tpu_torch.models.integrators.projection import SilhouetteSample
from mitsuba_tpu_torch.utils.params import traverse, update
from mitsuba_tpu_torch.utils.scenes import probe_panel, shadow_scene
from test_projection import _sphere_scene
from test_projective import _probe_panel_scene, _shadow_scene
from torch_parity import export_scene

SHADOW = dict(size=32, n=2048, seed=3)
PANEL = dict(size=24, n=4096, seed=5, depth=2)
GUIDED = dict(n=2048, seed=9)
WALK = dict(n=4096, max_walk=24, seed=11)
BLOCKER = "meshes.1.vertices"


class _StaticRadius(float):
    """A scene radius that jit keeps static: the depth-k pass reads it as a
    Python float (projective.py:667)."""


jax.tree_util.register_static(_StaticRadius)


def _static_radius(scene):
    return scene.replace(scene_radius=_StaticRadius(float(scene.scene_radius)))


def _ramp(size):
    """tests/test_projective.py's x-ramp loss weights."""
    return np.broadcast_to(np.arange(size, dtype=np.float32)[None, :, None]
                           / size, (size, size, 3)).copy()


def _jgrads(scene, g):
    """{path: numpy} of a list of JAX gradients over the float leaves."""
    g = _float_partition(scene)[2](g)
    return {k: np.asarray(v) for k, v in jtraverse(g).items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)}


def _blocker_x_tangent(scene):
    """The JAX tangent list moving the blocker (mesh 1) along +x."""
    floats, _, cot = _float_partition(scene)
    t = cot([jnp.zeros_like(x) for x in floats])
    t = t.replace(meshes=tuple(
        m.replace(vertices=jnp.zeros_like(m.vertices).at[:, 0].set(
            1.0 if i == 1 else 0.0)) for i, m in enumerate(t.meshes)))
    return _float_partition(t)[0]


def _port_tangent(scene):
    t = torch.zeros_like(traverse(scene)[BLOCKER])
    t[:, 0] = 1.0
    return {BLOCKER: t}


class _JitPasses:
    """The JAX package's ``_indirect_pass`` jitted, with every call's
    arguments and outputs recorded."""

    def __init__(self):
        self.jit = jax.jit(jproj._indirect_pass, static_argnames=(
            "n_samples", "eps_frac", "collect", "indirect_depth"))
        self.calls = []

    def __call__(self, *args, **kw):
        out = self.jit(*args, **kw)
        self.calls.append((args, kw, out))
        return out


def _jit_queries(mp):
    """The JAX scene's hit queries jitted on their own: each traces once
    for all the calls of a shape, whichever pass makes them."""
    mp.setattr(JScene, "ray_test", jax.jit(JScene.ray_test))
    mp.setattr(JScene, "ray_intersect_preliminary",
               jax.jit(JScene.ray_intersect_preliminary))
    mp.setattr(JScene, "compute_si",
               jax.jit(JScene.compute_si, static_argnames=("mode",)))
    mp.setattr(JScene, "bsdf_eval_pdf", jax.jit(JScene.bsdf_eval_pdf))
    mp.setattr(JCamera, "sample_direction",
               jax.jit(JCamera.sample_direction))


@pytest.fixture(scope="module")
def jax_refs():
    shadow = _static_radius(_shadow_scene())
    panel = _static_radius(_probe_panel_scene())
    sphere = _static_radius(_sphere_scene(subdiv=2))
    se, pe = (jproj.build_silhouette_edges(s) for s in (shadow, panel))
    ws = jnp.asarray(_ramp(SHADOW["size"]))
    wp = jnp.ones((PANEL["size"],) * 2 + (3,), jnp.float32)
    out = {}
    passes = _JitPasses()
    with pytest.MonkeyPatch.context() as mp:
        _jit_queries(mp)
        mp.setattr(jproj, "_indirect_pass", passes)
        mp.setattr(jprojection, "project_seed_points", jax.jit(
            jprojection.project_seed_points,
            static_argnames=("n_seeds", "max_walk")))
        out["shadow_diag"] = jproj._indirect_pass(
            shadow, se, ws, jnp.uint32(SHADOW["seed"]), SHADOW["n"], 0.01,
            diag_tangent=_blocker_x_tangent(shadow))
        out["panel_diag"] = jproj._indirect_pass(
            panel, pe, wp, jnp.uint32(PANEL["seed"]), PANEL["n"], 0.01,
            indirect_depth=PANEL["depth"],
            diag_tangent=_blocker_x_tangent(panel))
        for mode in ("octree", "projective"):
            first = len(passes.calls)
            out[mode] = jproj.indirect_boundary_grads(
                shadow, se, ws, jnp.uint32(GUIDED["seed"]),
                n_samples=GUIDED["n"], guiding=mode)
            out[f"{mode}_warmup"] = passes.calls[first]
    sphere_refs = _jax_projection(sphere)
    return dict(
        shadow=shadow, panel=panel, sphere=sphere, **sphere_refs,
        shadow_port=scene_from_numpy(export_scene(shadow), device="cpu"),
        panel_port=scene_from_numpy(export_scene(panel), device="cpu"),
        sphere_port=scene_from_numpy(export_scene(sphere), device="cpu"),
        **out)


def _walk_inputs(sphere):
    """Start faces on the sphere (20 * 4^2 faces), their centroids, and the
    viewpoint (0, 0, 4), from a numpy seed."""
    n = WALK["n"]
    f = np.asarray(sphere.geometry()[1])
    v = np.asarray(sphere.geometry()[0])
    prim = np.random.default_rng(WALK["seed"]).integers(0, 320, n)
    return prim, v[f[prim]].mean(axis=1).astype(np.float32), \
        np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (n, 3)).copy()


def _jax_projection(sphere):
    """The JAX package's face adjacency, walk, hybrid projection and seed
    points on the sphere scene."""
    edges = jproj.build_silhouette_edges(sphere)
    adj = jprojection.build_face_adjacency(sphere, edges)
    prim, p0, vp = _walk_inputs(sphere)
    lane = jnp.arange(WALK["n"], dtype=jnp.int32)
    active = jnp.ones(WALK["n"], bool)
    seed = jnp.uint32(WALK["seed"])

    class SI:
        prim_index = jnp.asarray(prim, jnp.int32)
        p = jnp.asarray(p0)
        shape_index = jnp.zeros(WALK["n"], jnp.int32)

    @jax.jit
    def run(scene):
        verts, faces = scene.geometry()[:2]
        fn = jproj._face_normals(verts, faces)
        walk = jprojection.mesh_walk(verts, faces, fn, adj, jnp.asarray(vp),
                                     SI.prim_index, seed, lane, active,
                                     max_walk=WALK["max_walk"])
        hybrid = jprojection.hybrid_projection(
            scene, scene.trace_ctx(), edges, adj, jnp.asarray(vp), SI(), seed,
            lane, active, max_walk=WALK["max_walk"])
        return walk, hybrid, jprojection.project_seed_points(
            scene, edges, adj, seed, WALK["n"])

    walk, hybrid, seeds = run(sphere)
    return dict(sphere_adj=adj, walk=walk, hybrid=hybrid, seeds=seeds)


def _rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_grads(got, want, skip=()):
    """Every leaf JAX gives a nonzero gradient within 1e-3; the rest zero."""
    keys = [k for k in want if np.linalg.norm(want[k]) > 0 and k not in skip]
    assert BLOCKER in keys
    errs = {k: _rel(got[k], want[k]) for k in keys}
    assert all(e <= 1e-3 for e in errs.values()), errs
    assert all(float(got[k].abs().sum()) == 0.0 for k in want
               if k in got and k not in keys and k not in skip)


# ------------------------------------------------------------- the octree

def test_octree_matches_jax():
    """OcSpaceDistr from the same numpy points and masses: the leaf boxes
    equal, the pmf within 1e-6, and 4,096 draws' points and pdfs (sample
    and pdf) within 1e-6."""
    r = np.random.default_rng(3)
    pts = r.uniform(size=(4000, 3)).astype(np.float32)
    mass = np.exp(-30 * np.sum((pts - [0.8, 0.2, 0.5]) ** 2, -1)).astype(
        np.float32)
    want = JOcSpace.create_from_samples(jnp.asarray(pts), jnp.asarray(mass))
    got = OcSpaceDistr.create_from_samples(torch.tensor(pts),
                                           torch.tensor(mass))
    assert got.n_leaves == want.n_leaves > 8
    np.testing.assert_array_equal(got.leaf_min.numpy(),
                                  np.asarray(want.leaf_min))
    np.testing.assert_array_equal(got.leaf_max.numpy(),
                                  np.asarray(want.leaf_max))
    np.testing.assert_allclose(got.distr.pmf.numpy(),
                               np.asarray(want.distr.pmf), rtol=1e-6)
    u1 = r.random(4096, np.float32)
    u3 = r.random((4096, 3), np.float32)
    p, pdf = got.sample(torch.tensor(u1), torch.tensor(u3))
    wp, wpdf, wdens = jax.jit(lambda oc, u1, u3, p: (*oc.sample(u1, u3),
                                                    oc.pdf(p)))(
        want, jnp.asarray(u1), jnp.asarray(u3), jnp.asarray(p.numpy()))
    np.testing.assert_allclose(p.numpy(), np.asarray(wp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(wpdf), rtol=1e-6)
    np.testing.assert_allclose(got.pdf(p).numpy(), np.asarray(wdens),
                               rtol=1e-6)


# --------------------------------------------------------- the projection

def _assert_lanes(got: SilhouetteSample, want, share=0.999):
    """edge and valid equal on ``share`` of the lanes, t within 1e-5
    there."""
    same = (got.edge.numpy() == np.asarray(want.edge)) \
        & (got.valid.numpy() == np.asarray(want.valid))
    same &= np.abs(got.t.numpy() - np.asarray(want.t)) <= 1e-5
    assert same.mean() >= share, same.mean()
    assert got.valid.float().mean() > 0.1


def test_face_adjacency_matches_jax(jax_refs):
    scene = jax_refs["sphere_port"]
    got = build_face_adjacency(scene, build_silhouette_edges(scene))
    want = jax_refs["sphere_adj"]
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    np.testing.assert_array_equal(got.edge_id.numpy(),
                                  np.asarray(want.edge_id))


@pytest.mark.parametrize("op", ["mesh_walk", "hybrid_projection",
                                "project_seed_points"])
def test_projection_matches_jax(jax_refs, op):
    """The walk (24 steps), the hybrid projection and the light-side seed
    points on the smooth sphere (320 faces, brute hits in both packages)
    lane by lane: edge and valid equal on >= 99.9 % of 4,096 lanes, t
    within 1e-5 there (the walk's arccos weights may pick another slot
    in rare lanes under rounding)."""
    scene = jax_refs["sphere_port"]
    edges = build_silhouette_edges(scene)
    adj = build_face_adjacency(scene, edges)
    prim, p0, vp = _walk_inputs(jax_refs["sphere"])
    n = WALK["n"]
    lane = torch.arange(n)
    active = torch.ones(n, dtype=torch.bool)
    verts, faces = scene.geometry()[:2]
    if op == "mesh_walk":
        got = mesh_walk(verts, faces, projective._face_normals(verts, faces),
                        adj, torch.tensor(vp), torch.tensor(prim),
                        WALK["seed"], lane, active, max_walk=WALK["max_walk"])
        _assert_lanes(got, jax_refs["walk"])
    elif op == "hybrid_projection":
        si = dataclasses.make_dataclass("SI", ["prim_index", "p",
                                               "shape_index"])(
            torch.tensor(prim), torch.tensor(p0), torch.zeros(n, dtype=int))
        got = hybrid_projection(scene, scene.trace_ctx(), edges, adj,
                                torch.tensor(vp), si, WALK["seed"], lane,
                                active, max_walk=WALK["max_walk"])
        _assert_lanes(got, jax_refs["hybrid"])
    else:
        pts, ok = project_seed_points(scene, edges, adj, WALK["seed"], n)
        wpts, wok = (np.asarray(x) for x in jax_refs["seeds"])
        same = (ok.numpy() == wok) & np.all(
            np.abs(pts.numpy() - wpts) <= 1e-5, axis=-1)
        assert same.mean() >= 0.999 and ok.float().mean() > 0.05


# --------------------------------------------------------- the shadow term

@pytest.mark.parametrize("case", ["shadow", "panel"])
def test_indirect_pass_per_lane(jax_refs, case):
    """_indirect_pass on the shadow scene (depth 1, 2,048 samples) and the
    probe panel (depth 2, 4,096): each lane's directional derivative along
    the blocker's x within 1e-4 relative + 1e-6 of the JAX package's
    diag_tangent on >= 99.9 % of lanes, the cube points equal, and the
    summed gradients within 1e-3."""
    run = SHADOW if case == "shadow" else PANEL
    scene = jax_refs[f"{case}_port"]
    w = (_ramp(run["size"]) if case == "shadow"
         else np.ones((run["size"],) * 2 + (3,), np.float32))
    g, pts, dt = projective._indirect_pass(
        scene, build_silhouette_edges(scene), torch.tensor(w), run["seed"],
        run["n"], indirect_depth=run.get("depth", 1),
        diag_tangent=_port_tangent(scene))
    wg, wpts, wdt = jax_refs[f"{case}_diag"]
    wdt = np.asarray(wdt)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(wpts))
    assert dt.shape == wdt.shape == (run["n"], run.get("depth", 1))
    close = np.abs(dt.numpy() - wdt) <= 1e-4 * np.abs(wdt) + 1e-6
    assert close.all(-1).mean() >= 0.999
    assert (wdt != 0).any(-1).sum() >= 10
    if case == "panel":     # the depth-2 connection carries the gradient
        assert np.abs(wdt[:, 1]).sum() > np.abs(wdt[:, 0]).sum()
    _assert_grads(g, _jgrads(jax_refs[case], wg))


def test_indirect_pass_collect(jax_refs):
    """The octree's warm-up pass (512 uniform cube points under the
    warm-up salt) with collect: the points equal and each lane's |mass|
    within 1e-4 relative + 1e-6 of the JAX package's."""
    args, kw, (_, wpts, wmass) = jax_refs["octree_warmup"]
    scene = jax_refs["shadow_port"]
    _, pts, mass = projective._indirect_pass(
        scene, build_silhouette_edges(scene),
        torch.tensor(np.asarray(args[2])), int(args[3]), args[4], args[5],
        collect=True)
    assert kw["collect"] and kw["points"] is None
    np.testing.assert_array_equal(pts.numpy(), np.asarray(wpts))
    wmass = np.asarray(wmass)
    assert (wmass > 0).sum() >= 10
    np.testing.assert_allclose(mass.numpy(), wmass, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("guiding", ["octree", "projective"])
def test_guided_shadow_grads_match_jax(jax_refs, guiding):
    """indirect_boundary_grads on the shadow scene (2,048 samples, the
    warm-up 512) with the octree and the projection-seeded octree: every
    leaf's gradient within 1e-3 of the JAX package's at the same seed."""
    scene = jax_refs["shadow_port"]
    got = indirect_boundary_grads(
        scene, build_silhouette_edges(scene),
        torch.tensor(_ramp(SHADOW["size"])), GUIDED["seed"],
        n_samples=GUIDED["n"], guiding=guiding)
    _assert_grads(got, _jgrads(jax_refs["shadow"], jax_refs[guiding]))


def _render_grads(scene, integ, spp, seed, w):
    """{path: gradient} of every mesh's vertices through
    prb_projective_render."""
    leaves = {k: v.clone().requires_grad_() for k, v in traverse(
        scene).items() if k.endswith("vertices")}
    img = prb_projective_render(update(scene, leaves),
                                build_silhouette_edges(scene), integ, seed,
                                spp, device="cpu")
    torch.sum(img * w).backward()
    return {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("integ", [
    PathProjectiveIntegrator(max_depth=2, sppp=256, n_sub=1, guiding="grid",
                             sppi=SHADOW["n"]),
    DirectProjectiveIntegrator(sppp=256, n_sub=1, guiding="uniform",
                               sppi=SHADOW["n"])])
def test_projective_render_shadow_term(jax_refs, integ):
    """prb_projective_render with indirect=True on the shadow scene (32x32
    x 2 spp) adds to the vertex gradients exactly the JAX package's shadow
    term of its ``_ppr_bwd``: uniform at sppi samples (any guiding but
    "octree" and "projective"), depth 1, the render's seed; the
    difference of the gradients with and without the term within 1e-3 of
    JAX's ``indirect_boundary_grads`` at those settings.  (The whole
    render against JAX's is the slow ``test_projective_render_matches_jax``:
    compiling JAX's PRB backward takes 40-60 s.)"""
    scene = jax_refs["shadow_port"]
    w = torch.tensor(_ramp(SHADOW["size"]))
    with_term = _render_grads(scene, integ, 2, SHADOW["seed"], w)
    without = _render_grads(scene, dataclasses.replace(integ, indirect=False),
                            2, SHADOW["seed"], w)
    want = _jgrads(jax_refs["shadow"], jax_refs["shadow_diag"][0])
    _assert_grads({k: with_term[k] - without[k] for k in with_term},
                  {k: v for k, v in want.items() if k.endswith("vertices")})


@pytest.mark.slow
def test_projective_render_matches_jax(jax_refs):
    """prb_projective_render with indirect=True on the shadow scene (32x32
    x 2 spp, depth 2, 256 primary and 2,048 shadow samples): every mesh's
    vertex gradient (PRB's, the primary term's and the shadow term's)
    within 1e-3 of the JAX package's.  The camera pose is left out: the
    JAX package drops its continuous part (ROADMAP.md Queue 3,
    ``_ppr_bwd``)."""
    jscene = jax_refs["shadow"]
    integ = dict(max_depth=2, sppp=256, n_sub=1, guiding="uniform",
                 sppi=2048)
    w = _ramp(SHADOW["size"])
    edges = jproj.build_silhouette_edges(jscene)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jproj, "_indirect_pass", _JitPasses())
        _, vjp = jax.jit(lambda s: jax.vjp(
            lambda sc: jproj.prb_projective_render(sc, edges, JPPI(**integ),
                                                   1, 2), s))(jscene)
        want = vjp(jnp.asarray(w))[0]
    got = _render_grads(jax_refs["shadow_port"],
                        PathProjectiveIntegrator(**integ), 2, 1,
                        torch.tensor(w))
    _assert_grads(got, {k: np.asarray(v) for k, v in jtraverse(want).items()
                        if k.endswith("vertices")})


def test_shadow_scenes_match_jax(jax_refs):
    """utils/scenes.py's shadow_scene and probe_panel are the JAX tests'
    scenes: every array of the converted JAX scenes, moved as the finite
    differences move them."""
    from test_projective import _recv_scene

    pairs = [(shadow_scene(device="cpu"), jax_refs["shadow"]),
             (shadow_scene(bx=0.03, device="cpu"), _shadow_scene(0.03)),
             (shadow_scene(floor_z=-0.03, blocker_x=0.06, device="cpu"),
              _recv_scene(-0.03)),
             (probe_panel(device="cpu"), jax_refs["panel"]),
             (probe_panel(bx=0.05, mirror=True, device="cpu"),
              _probe_panel_scene(0.05, mirror=True))]
    for port, jscene in pairs:
        got = traverse(port)
        want = traverse(scene_from_numpy(export_scene(jscene), device="cpu"))
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


# ------------------------------------------- finite differences (slow)

def _x_grad(scene, edges, integ, seed, spp, w, key=BLOCKER, axis=0):
    leaf = traverse(scene)[key].clone().requires_grad_()
    img = prb_projective_render(update(scene, {key: leaf}), edges, integ,
                                seed, spp, device="cpu")
    torch.sum(img * w).backward()
    return float(leaf.grad[:, axis].sum())


def _loss(scene, edges, integ, seed, spp, w):
    with torch.no_grad():
        return float(torch.sum(prb_projective_render(
            scene, edges, integ, seed, spp, device="cpu") * w))


@pytest.mark.slow
def test_shadow_boundary_gradient_matches_fd():
    """tests/test_projective.py's case on the port: the blocker's
    x-translation gradient (32x32, spp 32, sppp 4096, n_sub 2, depth 2)
    within 0.3 |fd| + 0.05 of central differences (h = 0.03); without the
    shadow term under 0.3 |fd|."""
    spp, h = 32, 0.03
    w = torch.tensor(_ramp(32))
    integ = PathProjectiveIntegrator(max_depth=2, sppp=4096, n_sub=2)
    scene = shadow_scene(device="cpu")
    edges = build_silhouette_edges(scene)
    ad = _x_grad(scene, edges, integ, 0, spp, w)
    fd = (_loss(shadow_scene(bx=h, device="cpu"), edges, integ, 0, spp, w)
          - _loss(shadow_scene(bx=-h, device="cpu"), edges, integ, 0, spp,
                  w)) / (2 * h)
    assert np.isfinite(ad) and abs(ad - fd) < 0.3 * abs(fd) + 0.05, (ad, fd)
    ad0 = _x_grad(scene, edges, dataclasses.replace(integ, indirect=False),
                  0, spp, w)
    assert abs(ad0) < 0.3 * abs(fd), (ad0, fd)


@pytest.mark.slow
def test_receiver_motion_boundary_matches_fd():
    """Moving the receiver (the floor along z, the blocker off centre)
    reproduces central differences: the mean of three seeds' gradients
    within 0.35 |fd| + 0.05 (h = 0.03)."""
    spp, h = 32, 0.03
    w = torch.tensor(_ramp(32))
    integ = PathProjectiveIntegrator(max_depth=2, sppp=4096, n_sub=2)

    def recv(fz):
        return shadow_scene(floor_z=fz, blocker_x=0.06, device="cpu")

    scene = recv(0.0)
    edges = build_silhouette_edges(scene)
    ads = [_x_grad(scene, edges, integ, sd, spp, w, key="meshes.0.vertices",
                   axis=2) for sd in (0, 1, 2)]
    ad = float(np.mean(ads))
    fd = (_loss(recv(h), edges, integ, 0, spp, w)
          - _loss(recv(-h), edges, integ, 0, spp, w)) / (2 * h)
    assert np.isfinite(ad) and abs(ad - fd) < 0.35 * abs(fd) + 0.05, \
        (ad, fd, ads)


def _fd_crn(make, depth, h=0.05, seeds=4, spp=512):
    """A common-random-number central difference of the panel's brightness
    and its standard error."""
    fds = []
    for sd in range(seeds):
        lp, lm = (float(torch.sum(render(make(s * h), PathIntegrator(
            max_depth=depth), seed=sd, spp=spp, device="cpu")))
            for s in (1, -1))
        fds.append((lp - lm) / (2 * h))
    return float(np.mean(fds)), float(np.std(fds) / np.sqrt(len(fds)))


def _boundary_ad(scene, depth, seeds, n_samples=65536):
    edges = build_silhouette_edges(scene)
    w = torch.ones((24, 24, 3))
    return float(np.mean([float(indirect_boundary_grads(
        scene, edges, w, sd, n_samples=n_samples, indirect_depth=depth,
        params={BLOCKER: traverse(scene)[BLOCKER]})[BLOCKER][:, 0].sum())
        for sd in seeds]))


@pytest.mark.slow
def test_depth2_shadow_boundary_matches_fd():
    """The shadow seen through one bounce (the probe panel): depth 2 within
    12 % of a common-random-number FD (4 seeds x 512 spp), depth 1 under
    5 % (the JAX package's CPU anchors: FD -253.0, ad2 -245.7)."""
    fd, fd_err = _fd_crn(lambda b: probe_panel(bx=b, device="cpu"), depth=3)
    assert abs(fd) > 50.0 and fd_err < 0.05 * abs(fd), (fd, fd_err)
    scene = probe_panel(device="cpu")
    ad2 = _boundary_ad(scene, 2, (0, 1, 2, 3))
    ad1 = _boundary_ad(scene, 1, (0, 1))
    assert abs(ad2 - fd) < 0.12 * abs(fd), (ad2, fd)
    assert abs(ad1) < 0.05 * abs(fd), (ad1, fd)


@pytest.mark.slow
def test_depth3_shadow_boundary_matches_fd():
    """The shadow seen through two bounces by way of the mirror: depth 3
    within 15 % of the FD, depth 2 under 5 % (the JAX package's CPU
    anchors: FD -73.4, ad3 -70.8)."""
    fd, fd_err = _fd_crn(lambda b: probe_panel(bx=b, mirror=True,
                                               device="cpu"), depth=4)
    assert abs(fd) > 20.0 and fd_err < 0.08 * abs(fd), (fd, fd_err)
    scene = probe_panel(mirror=True, device="cpu")
    ad3 = _boundary_ad(scene, 3, (0, 1, 2, 3, 4, 5))
    ad2 = _boundary_ad(scene, 2, (0, 1))
    assert np.isfinite(ad3) and abs(ad3 - fd) < 0.15 * abs(fd), (ad3, fd)
    assert abs(ad2) < 0.05 * abs(fd), (ad2, fd)
