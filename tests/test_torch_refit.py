"""The port refits its BVH on every render, against mitsuba_tpu, on the CPU.

The scene is the Cornell box with ``sphere_mesh(3)`` (1,316 faces, so a
BVH), its ball moved by -0.5 in x through ``utils/params.update``, with
no ``refresh_accel``.  The JAX package refits its tree's boxes to the
current vertices on every render (scene.py:155-170); so must the port.
Hits are held against a fresh build of the moved scene and against the
JAX package's ``ray_intersect`` on the same moved scene: they may part
only at ties (equal t, another face), at most 1 ray in 1,000.  Walking
the stale tree, 57 of 1,024 camera rays hit another face.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.records import Ray as JRay
from mitsuba_tpu.ops.bvh import refit_bvh as jrefit_bvh
from mitsuba_tpu.utils.params import update as jupdate
from mitsuba_tpu_torch import sample_rays, scene_from_numpy
from mitsuba_tpu_torch.ops.bvh import pack_node_pairs, refit_bvh
from mitsuba_tpu_torch.ops.traverse import pack_bvh_geometry
from mitsuba_tpu_torch.utils.params import refresh_accel, update
from torch_parity import export_scene, jax_scene_with_ball

SEED, SPP = 3, 4
BALL = "meshes.8.vertices"
SHIFT = np.array([-0.5, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def moved():
    """The JAX scene and the port's, both with the ball moved, the port's
    camera rays and shadow rays toward the light, and the JAX package's
    hits and occlusion of the same rays (one reference for the module)."""
    jscene = jax_scene_with_ball(16, 16, 3, use_bvh=True)
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    v = scene.meshes[8].vertices.numpy() + SHIFT
    jmoved = jupdate(jscene, {BALL: jnp.asarray(v)})
    port = update(scene, {BALL: torch.from_numpy(v)})
    ray, _, _, lane = sample_rays(port, SEED, SPP)
    active = torch.ones(lane.shape, dtype=torch.bool)
    ctx = port.trace_ctx()
    si = port.ray_intersect(ray, active, ctx)
    hit = si.is_valid()
    light = torch.tensor([0.0, 0.99, 0.0]).expand_as(si.p)
    shadow = si.spawn_ray_to(light)

    @jax.jit
    def reference(sc, o, d, maxt, so, sd, smaxt, shadow_active):
        pi = sc.ray_intersect_preliminary(JRay.make(o, d, maxt),
                                          jnp.ones(o.shape[:1], bool))
        occ = sc.ray_test(JRay.make(so, sd, smaxt), shadow_active)
        v = jnp.concatenate([m.vertices for m in sc.meshes])
        tree = jrefit_bvh(sc.accel, v)
        return pi.t, pi.prim_index, occ, tree.bbox_lo, tree.bbox_hi

    jt, jprim, jocc, jlo, jhi = reference(
        jmoved, *(jnp.asarray(x.numpy()) for x in (
            ray.o, ray.d, ray.maxt, shadow.o, shadow.d, shadow.maxt, hit)))
    return dict(jscene=jscene, jmoved=jmoved, scene=scene, port=port,
                ray=ray, active=active, shadow=shadow, hit=hit,
                jt=np.asarray(jt), jprim=np.asarray(jprim),
                jocc=np.asarray(jocc), jlo=np.asarray(jlo),
                jhi=np.asarray(jhi))


def _hits(scene, ray, active):
    pi = scene.ray_intersect_preliminary(ray, active, scene.trace_ctx())
    return pi.t.numpy(), pi.prim_index.numpy()


def _assert_same_hits(t, prim, t_ref, prim_ref):
    """Equal hits and faces, t within 1e-5 relative; a ray whose face
    differs counts as a tie only at an equal t (1e-6 relative), and ties
    are at most 1 in 1,000."""
    assert np.array_equal(np.isfinite(t), np.isfinite(t_ref))
    both = np.isfinite(t) & np.isfinite(t_ref)
    assert np.allclose(t[both], t_ref[both], rtol=1e-5, atol=0)
    other = both & (prim != prim_ref)
    tie = other & np.isclose(t, t_ref, rtol=1e-6, atol=0)
    assert not (other & ~tie).any(), int((other & ~tie).sum())
    assert tie.sum() <= len(t) // 1000, int(tie.sum())


def test_hits_after_update_equal_a_rebuild(moved):
    t, prim = _hits(moved["port"], moved["ray"], moved["active"])
    t_ref, prim_ref = _hits(refresh_accel(moved["port"]), moved["ray"],
                            moved["active"])
    _assert_same_hits(t, prim, t_ref, prim_ref)


def test_hits_after_update_equal_jax(moved):
    t, prim = _hits(moved["port"], moved["ray"], moved["active"])
    _assert_same_hits(t, prim, moved["jt"], moved["jprim"])


def test_shadow_rays_after_update_equal_jax(moved):
    port = moved["port"]
    occ = port.ray_test(moved["shadow"], moved["hit"], port.trace_ctx())
    assert np.array_equal(occ.numpy(), moved["jocc"])


def test_stale_tree_walks_other_faces(moved):
    """Without the refit (the moved faces over the unmoved tree's boxes)
    many rays find other faces: what the refit repairs."""
    port = moved["port"]
    ctx = port.trace_ctx()
    v, f = port.geometry()[:2]
    p = v[f]
    ctx["bvh"] = pack_bvh_geometry(port.accel, torch.cat(
        [p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1))
    pi = port.ray_intersect_preliminary(moved["ray"], moved["active"], ctx)
    prim = pi.prim_index.numpy()
    _, prim_ref = _hits(port, moved["ray"], moved["active"])
    assert (prim != prim_ref).sum() > 10


def test_refit_boxes_equal_jax_and_enclose_faces(moved):
    port = moved["port"]
    v, f = (x.numpy() for x in port.geometry()[:2])
    tree = refit_bvh(port.accel, torch.from_numpy(v))
    lo, hi = tree.bbox_lo.numpy(), tree.bbox_hi.numpy()
    np.testing.assert_allclose(lo, moved["jlo"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(hi, moved["jhi"], rtol=1e-6, atol=1e-7)
    assert not np.array_equal(lo, port.accel.bbox_lo.numpy())
    # every leaf's box holds its faces, and every node its children
    first, count = tree.first.numpy(), tree.count.numpy()
    miss, prims = tree.miss.numpy(), tree.prims.numpy()
    for node in np.nonzero(count > 0)[0]:
        p = v[f[prims[first[node]:first[node] + count[node]]]].reshape(-1, 3)
        assert (lo[node] <= p).all() and (p <= hi[node]).all()
    inner = np.nonzero(count == 0)[0]
    for child in (inner + 1, miss[inner + 1]):
        assert (lo[inner] <= lo[child]).all()
        assert (hi[child] <= hi[inner]).all()


def test_refit_node_pairs_equal_a_repack(moved):
    port = moved["port"]
    tree = refit_bvh(port.accel, port.geometry()[0])
    want, depth = pack_node_pairs(
        tree.bbox_lo.numpy(), tree.bbox_hi.numpy(), tree.first.numpy(),
        tree.count.numpy(), tree.miss.numpy())
    assert depth == tree.depth == port.accel.depth
    assert np.array_equal(tree.node_pair.numpy().view(np.int32),
                          want.view(np.int32))


def test_refit_of_the_built_geometry_changes_nothing(moved):
    scene = moved["scene"]
    tree = refit_bvh(scene.accel, scene.geometry()[0])
    for name in ("bbox_lo", "bbox_hi"):
        assert torch.equal(getattr(tree, name), getattr(scene.accel, name))
    assert torch.equal(tree.node_pair.view(torch.int32),
                       scene.accel.node_pair.view(torch.int32))


def test_refit_needs_the_build_tables(moved):
    """A tree without ``build_bvh``'s refit tables is refused, never
    walked with its built boxes."""
    port = moved["port"]
    tree = dataclasses.replace(port.accel, refit=None)
    with pytest.raises(ValueError, match="refit tables"):
        refit_bvh(tree, port.geometry()[0])
    with pytest.raises(ValueError, match="refit tables"):
        dataclasses.replace(port, accel=tree).trace_ctx()
