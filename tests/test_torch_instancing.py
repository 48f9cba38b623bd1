"""Two-level instancing in the port against mitsuba_tpu, on the CPU: the
candidate selection, the group's closest and any hit, the instanced
interaction and its gradients with respect to the transforms and the
group's vertices, per-lane renders against the JAX package's and
against the flattened twin, a group above MAX_FACES through the port's
walk, and parameter updates, with the JAX package's fault that its
instance boxes go stale.

The scenes are ``instanced_cornell`` and its JAX twin
(``tests/torch_parity.py::jax_instanced_cornell``) carried across by
``export_scene``; rays are made from seeds with numpy.  On the CPU the
JAX package queries a group by brute force (``intersect_brute``) and the
port by the plain versions of #1 and #5 / #6.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.records import Ray as JRay
from mitsuba_tpu.models import instancing as jinst
from mitsuba_tpu_torch import (InstancedGroup, MegakernelPathIntegrator,
                               PathIntegrator, instanced_cornell, sample_rays,
                               scene_from_numpy)
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.models import instancing
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.shapes import Mesh, sphere_mesh
from mitsuba_tpu_torch.utils.params import traverse, update
from torch_parity import export_scene, jax_instanced_cornell, jax_path_lanes

TO_WORLD = "instances.0.to_world"
VERTS = "instances.0.vertices"


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(scope="module")
def scenes():
    """{subdiv: (JAX twin, the port's scene converted from it)} of
    instanced_cornell(16, 16, 3, 3, subdiv), box filter: subdiv 1 is an
    80-face group (#1), subdiv 4 a 5,120-face one with a tree (#5 / #6)."""
    from mitsuba_tpu.models.film import ReconstructionFilter as JRF
    out = {}
    for sub in (1, 4):
        j = jax_instanced_cornell(16, 16, 3, 3, sub, rfilter=JRF.box())
        out[sub] = (j, scene_from_numpy(export_scene(j), device="cpu"))
    return out


@jax.jit
def _jax_preliminary(jscene, o, d):
    """The JAX package's preliminary hits of rays (o, d), the scene an
    argument, so that scenes of one structure share the compiled
    program."""
    return jscene.ray_intersect_preliminary(JRay.make(o, d),
                                            jnp.ones(o.shape[0], bool))


def _rays(n=2048, seed=0, maxt=False):
    """Rays from in front of the grid toward its plane (z = 0.9), some
    from inside the box; with ``maxt`` a finite maxt of 0.5-2."""
    r = np.random.default_rng(seed)
    o = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 2] = r.uniform(0.5, 2.0, n)
    tgt = r.uniform(-0.8, 0.8, (n, 3))
    tgt[:, 2] = 0.9 + r.uniform(-0.3, 0.3, n)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    m = (r.uniform(0.5, 2.0, n) if maxt else np.full(n, np.inf))
    return o, d, m.astype(np.float32), r.uniform(size=n) > 0.1


@pytest.mark.parametrize("subdiv", [1, 4])
def test_group_queries_match_jax(scenes, subdiv):
    """Candidate selection from scratch, the group's closest hit and its
    any hit on seeded rays: the boxes and to_object equal, the chosen
    instance and its entry t equal, hits equal with t within 1e-5 and
    face and instance equal on >= 99.9 % of lanes (the 5,120-face group
    by the port's plain walk against the JAX package's brute query), the
    occluded mask equal on >= 99.9 %."""
    jscene, scene = scenes[subdiv]
    jg, g = jscene.instances[0], scene.instances[0]
    assert (g.accel is not None) == (subdiv == 4)
    np.testing.assert_array_equal(g.world_lo.numpy(), np.asarray(jg.world_lo))
    np.testing.assert_array_equal(g.world_hi.numpy(), np.asarray(jg.world_hi))
    np.testing.assert_allclose(g.to_object.numpy(), np.asarray(jg.to_object),
                               atol=1e-6)
    o, d, _, active = _rays()
    n = o.shape[0]
    inf = np.full(n, np.inf, np.float32)
    inv = instancing._inv_dir(_t(d))
    c, tk = instancing.select_candidate(
        g, _t(o), inv, _t(inf), torch.full((n,), -np.inf),
        torch.full((n,), -1, dtype=torch.int64), _t(active))
    jinv = 1.0 / jnp.where(jnp.abs(_j(d)) > 1e-30, _j(d),
                           jnp.where(_j(d) >= 0, 1e-30, -1e-30))
    jc, jtk = jinst._select_candidate(jg, _j(o), jinv, _j(inf),
                                      jnp.full((n,), -jnp.inf),
                                      jnp.full((n,), -1, jnp.int32),
                                      _j(active))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jtk))
    assert (c.numpy() >= 0).mean() > 0.2
    jctx = jinst.group_trace_ctx(jg)
    ctx = instancing.group_trace_ctx(g, instancing.group_shading_ctx(g))
    assert ("bvh" in ctx) == (subdiv == 4)
    jt, jp, ji = (np.asarray(x) for x in jax.jit(
        lambda *a: jinst.group_closest(jg, jctx, *a))(
            _j(o), _j(d), _j(inf), _j(active)))
    instancing.reset_round_counts()
    t, p, i = (x.numpy() for x in instancing.group_closest(
        g, ctx, _t(o), _t(d), _t(inf), _t(active)))
    hit = np.isfinite(jt)
    assert (np.isfinite(t) == hit).mean() >= 0.999 and hit.mean() > 0.15
    both = hit & np.isfinite(t)
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5)
    assert ((p == jp) & (i == ji))[both].mean() >= 0.999
    q = instancing.group_closest
    assert q.queries == 1 and q.rounds == q.max_rounds >= 2
    o, d, maxt, active = _rays(seed=1, maxt=True)
    jocc = np.asarray(jax.jit(lambda *a: jinst.group_any(jg, jctx, *a))(
        _j(o), _j(d), _j(maxt), _j(active)))
    occ = instancing.group_any(g, ctx, _t(o), _t(d), _t(maxt),
                               _t(active)).numpy()
    assert (occ == jocc).mean() >= 0.999 and 0.05 < occ.mean() < 0.9


FIELDS = ("t", "p", "n", "sh_n", "uv", "wi")


def _weights(n, seed=2):
    r = np.random.default_rng(seed)
    shape = {"t": (), "uv": (2,)}
    return {f: r.normal(size=(n,) + shape.get(f, (3,))).astype(np.float32)
            for f in FIELDS}


def _loss(si, w, valid):
    return sum((getattr(si, f) * w[f]).reshape(w[f].shape[0], -1).sum(-1)
               for f in FIELDS)[valid].sum()


@pytest.mark.parametrize("mode", ["attach", "follow_shape", "detach_shape"])
def test_instanced_si_matches_jax(scenes, mode):
    """The scene's interaction on seeded rays that hit the 80-face balls
    (instanced_si in ``mode``): the fields within 1e-5 of the JAX
    package's, inst_index equal; the gradient of a seeded weighted sum of
    the fields with respect to to_world and the group's vertices within
    1e-3 of jax.grad's (JAX's to_object recomputed from to_world inside
    the differentiated function), relative to each leaf's largest entry;
    none in detach_shape."""
    jscene, scene = scenes[1]
    o, d, _, _ = _rays(seed=3)
    n = o.shape[0]
    active = np.ones(n, bool)
    jray = JRay.make(_j(o), _j(d))
    jpi = _jax_preliminary(jscene, _j(o), _j(d))
    ray = Ray(o=_t(o), d=_t(d), maxt=torch.full((n,), np.inf))
    pi = scene.ray_intersect_preliminary(ray, _t(active), scene.trace_ctx())
    on = np.asarray(jpi.inst_index) >= 0
    assert on.mean() > 0.2
    np.testing.assert_array_equal(pi.inst_index.numpy(),
                                  np.asarray(jpi.inst_index))
    np.testing.assert_array_equal(pi.prim_index.numpy()[on],
                                  np.asarray(jpi.prim_index)[on])
    w = _weights(n)
    jg = jscene.instances[0]

    def jloss(params):
        g = jg.replace(to_world=params["M"], vertices=params["v"],
                       to_object=jnp.linalg.inv(params["M"]))
        s = jscene.replace(instances=(g,))
        si = s.compute_si(jpi, jray, s.trace_ctx(), mode=mode)
        return jnp.sum(jnp.where(_j(on), sum(
            (getattr(si, f) * _j(w[f])).reshape(n, -1).sum(-1)
            for f in FIELDS), 0.0)), si

    (_, jsi), jgr = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {"M": jg.to_world, "v": jg.vertices})
    leaves = {TO_WORLD: traverse(scene)[TO_WORLD].clone().requires_grad_(),
              VERTS: traverse(scene)[VERTS].clone().requires_grad_()}
    s = update(scene, leaves)
    si = s.compute_si(pi, ray, mode=mode)
    np.testing.assert_array_equal(si.inst_index.numpy(),
                                  np.asarray(jpi.inst_index))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(si, f).detach().numpy()[on],
                                   np.asarray(getattr(jsi, f))[on],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    loss = _loss(si, {f: _t(v) for f, v in w.items()}, _t(on))
    if mode == "detach_shape":
        assert not loss.requires_grad
        return
    loss.backward()
    for key, jk in ((TO_WORLD, "M"), (VERTS, "v")):
        want = np.asarray(jgr[jk])
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(leaves[key].grad.numpy(), want,
                                   atol=1e-3 * scale, err_msg=key)


@pytest.mark.parametrize("subdiv", [1, 4])
def test_render_per_lane_matches_jax_and_flattened(scenes, subdiv):
    """The wavefront PathIntegrator (6, 5) on the 3 x 3 grid at 16x16 x 2
    spp, lane by lane against the JAX package's and against the port's
    flattened twin (instance_meshes): >= 99.5 % of lanes within 2e-3, the
    means within 2e-3."""
    jscene, scene = scenes[subdiv]
    integ = PathIntegrator(6, 5)

    def lanes(sc):
        ray, _, _, lane = sample_rays(sc, 5, 2)
        return integ.sample(sc, ray, lane, 5, torch.ones(
            lane.shape, dtype=torch.bool)).numpy()

    got = lanes(scene)
    flat = instanced_cornell(16, 16, 3, 3, subdiv, flattened=True,
                             device="cpu")
    flat = dataclasses.replace(flat, sensor=scene.sensor)
    refs = [lanes(flat)]
    if subdiv == 1:
        refs.append(jax_path_lanes(jscene, 5, 2))
    for want in refs:
        close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(-1)
        assert close.mean() >= 0.995, close.mean()
        assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def test_update_refreshes_to_object_and_bounds(scenes):
    """params.update of to_world recomputes to_object and the world boxes
    (an instance moved by 0.3 in y is hit at its new place); the JAX
    package's update keeps the boxes of create, so its moved instance is
    missed (ROADMAP Queue 3).  Group vertices update too."""
    # instance 4 is the grid's centre ball, at (0, 0, 0.9)
    from mitsuba_tpu.utils.params import update as jupdate
    jscene, scene = scenes[1]
    M = traverse(scene)[TO_WORLD].clone()
    M[4, 1, 3] += 0.3            # the centre ball, to y = 0.3 (a free row)
    moved = update(scene, {TO_WORLD: M})
    g = moved.instances[0]
    torch.testing.assert_close(g.to_object, torch.linalg.inv(M))
    assert float(g.world_lo[4, 1]) > 0.15
    assert torch.equal(scene.instances[0].world_lo,
                       scene.instances[0].world_lo)
    o = np.float32([[0.0, 0.3, 2.0], [0.0, 0.0, 2.0]])
    d = np.float32([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    ray = Ray(o=_t(o), d=_t(d), maxt=torch.full((2,), np.inf))
    act = torch.ones(2, dtype=torch.bool)
    pi = moved.ray_intersect_preliminary(ray, act, moved.trace_ctx())
    assert pi.inst_index.tolist() == [4, -1]
    assert abs(float(pi.t[0]) - (2.0 - 0.9 - 0.12)) < 2e-2
    jmoved = jupdate(jscene, {TO_WORLD: M.numpy(),
                              "instances.0.to_object": np.linalg.inv(
                                  M.numpy())})
    np.testing.assert_array_equal(np.asarray(jmoved.instances[0].world_lo),
                                  np.asarray(jscene.instances[0].world_lo))
    # the two rays among test_instanced_si_matches_jax's, whose compiled
    # query this reuses
    jo, jd, _, _ = _rays(seed=3)
    jo[:2], jd[:2] = o, d
    jpi = _jax_preliminary(jmoved, _j(jo), _j(jd))
    assert int(jpi.inst_index[0]) == -1     # the stale box: missed
    v = traverse(scene)[VERTS] * 1.5
    grown = update(scene, {VERTS: v}).instances[0]
    assert torch.equal(grown.vertices, v)
    assert float((grown.world_hi - grown.world_lo)[0, 0]) > 1.4 * float(
        (scene.instances[0].world_hi - scene.instances[0].world_lo)[0, 0])


def test_group_geometry_is_stored_once():
    """The group's geometry is stored once whatever the instance count
    (the JAX package's test_instanced_memory_is_o_blas); its device bytes
    stay below the flattened twin's."""
    small = instanced_cornell(8, 8, 2, 2, 2, device="cpu").instances[0]
    big = instanced_cornell(8, 8, 4, 4, 2, device="cpu").instances[0]
    assert small.vertices.shape == big.vertices.shape
    assert big.n_inst == 16 and small.n_inst == 4
    assert big.to_world.shape == (16, 4, 4)
    flat = instanced_cornell(8, 8, 4, 4, 2, flattened=True, device="cpu")
    flat_bytes = sum(m.vertices.numel() * 4 + m.faces.numel() * 8
                     + m.normals.numel() * 4 + m.uvs.numel() * 4
                     for m in flat.meshes[8:])
    assert big.nbytes < flat_bytes / 4


def test_emitter_in_group_raises_and_megapath_falls_back(scenes, caplog):
    """A submesh that carries an emitter raises in make_scene, as the
    reference's instance.cpp refuses it; MegakernelPathIntegrator logs its
    fallback for an instanced scene and gives the PathIntegrator's lanes
    bit for bit."""
    _, scene = scenes[1]
    v, f, n, uv = sphere_mesh(1)
    lamp = Mesh.make(v, f, normals=n, uvs=uv, emitter_index=0, device="cpu")
    group = InstancedGroup.create([lamp], [np.eye(4)], device="cpu")
    with pytest.raises(ValueError, match="emitters inside"):
        make_scene(scene.meshes, scene.bsdfs, scene.emitters, scene.sensor,
                   "cpu", instances=[group])
    ray, _, _, lane = sample_rays(scene, 5, 1)
    active = torch.ones(lane.shape, dtype=torch.bool)
    with caplog.at_level(logging.INFO):
        got = MegakernelPathIntegrator(6, 5).sample(scene, ray, lane, 5,
                                                    active)
    assert "instanced groups" in caplog.text
    assert torch.equal(got, PathIntegrator(6, 5).sample(scene, ray, lane, 5,
                                                        active))
