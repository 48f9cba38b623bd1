"""The port's host BVH and its plain walk against mitsuba_tpu/ops/bvh.py.

Both packages build with their own copy of the same SAH builder, so the
trees must be equal array for array; the walks visit leaves in the same
order with the same strict ``<``, so prim ids must be identical and t
equal to float rounding (the port's triangle test follows the megakernel's
order of operations, the JAX one ``ray_triangle``'s).  The one exception
is a true tie: the Cornell floor and the bottom of the small box resting
on it are coplanar, and a ray from below meets both at the same t to an
ulp, where even JAX's walk and its own ``ray_triangle`` differ by an ulp
(3 of 1,777 hits at the seed below).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.records import Ray
from mitsuba_tpu.models.shapes import sphere_mesh as jsphere_mesh
from mitsuba_tpu.ops import bvh as jbvh
from mitsuba_tpu.ops.intersect import ray_triangle
from mitsuba_tpu_torch import big_scene
from mitsuba_tpu_torch.models.shapes import sphere_mesh
from mitsuba_tpu_torch.ops import bvh
from mitsuba_tpu_torch.ops.traverse import (PAIR_STACK, pack_bvh_geometry,
                                            packet_any_hit,
                                            packet_any_hit_plain,
                                            packet_closest_hit, route_for)
from torch_parity import jax_scene_with_ball, rounding_tree


def _geometry(case):
    """(vertices, faces) numpy arrays of a test mesh."""
    if case == "sphere2":
        v, f, _, _ = sphere_mesh(2)
        return np.asarray(v), np.asarray(f)
    scene = jax_scene_with_ball(4, 4, 3, use_bvh=True)    # 1,316 faces
    offs = np.cumsum([0] + [m.vertices.shape[0] for m in scene.meshes])
    v = np.concatenate([np.asarray(m.vertices) for m in scene.meshes])
    f = np.concatenate([np.asarray(m.faces) + o
                        for m, o in zip(scene.meshes, offs)])
    return v, f


@pytest.fixture(scope="module", params=["sphere2", "cornell_sphere3"])
def geometry(request):
    v, f = _geometry(request.param)
    return v, f, jbvh.build_bvh(v, f, method="sah"), bvh.build_bvh(v, f, device="cpu")


def test_sphere_mesh_matches():
    for subdiv in (0, 2):
        for want, got in zip(jsphere_mesh(subdiv), sphere_mesh(subdiv)):
            np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def test_build_matches_jax(geometry):
    _, f, want, got = geometry
    for name in ("bbox_lo", "bbox_hi", "first", "count", "miss", "prims"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.prims.shape[0] == f.shape[0] + bvh.LEAF_SIZE


def _rays(v, n=4096, seed=7):
    """Rays from a shell around the mesh toward jittered points inside its
    box; every 8th ray is axis-aligned, so its inverse direction meets
    safe_rcp's +-1e30."""
    r = np.random.default_rng(seed)
    lo, hi = v.min(0), v.max(0)
    c, ext = (lo + hi) / 2, (hi - lo).max()
    o = c + r.normal(size=(n, 3)) * ext
    target = lo + r.random((n, 3)) * (hi - lo)
    d = target - o
    axis = r.integers(0, 3, n)
    d[::8] = 0.0
    d[np.arange(n)[::8], axis[::8]] = np.sign(c - o)[np.arange(n)[::8],
                                                     axis[::8]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = r.uniform(0.3, 2.0, n) * ext
    return o.astype(np.float32), d.astype(np.float32), maxt.astype(np.float32)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_intersect_bvh(geometry, any_hit):
    v, f, jtree, tree = geometry
    o, d, maxt = _rays(v)
    n = o.shape[0]
    ray = Ray(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt),
              time=jnp.zeros(n), wavelengths=jnp.zeros((n, 0)))
    pi = jbvh.intersect_bvh(jtree, jnp.asarray(v), jnp.asarray(f), ray,
                            any_hit=any_hit)
    want_t = np.asarray(pi.t)
    t, prim = bvh.intersect_bvh(tree, torch.tensor(v), torch.tensor(f).long(),
                                torch.tensor(o), torch.tensor(d),
                                torch.tensor(maxt), any_hit=any_hit)
    t, prim = t.numpy(), prim.numpy()
    hit = np.isfinite(want_t)
    assert 0.2 < hit.mean() < 0.95, hit.mean()   # a mix of hits and misses
    np.testing.assert_array_equal(np.isfinite(t), hit)
    if not any_hit:
        np.testing.assert_array_equal(prim[~hit], -1)
        np.testing.assert_allclose(t[hit], want_t[hit], rtol=1e-5)
        want_prim = np.asarray(pi.prim_index)
        tie = np.nonzero(hit & (prim != want_prim))[0]
        assert len(tie) <= 0.002 * hit.sum(), len(tie)
        # where the winners differ, JAX's own test meets the port's face
        # at JAX's t: a tie between coplanar faces, not a missed hit
        tri = jnp.asarray(v[f[prim[tie]]])
        t_other, *_ = ray_triangle(jnp.asarray(o[tie]), jnp.asarray(d[tie]),
                                   tri[:, 0], tri[:, 1], tri[:, 2])
        np.testing.assert_allclose(np.asarray(t_other), want_t[tie],
                                   rtol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_traversal_wrappers_equal_walk(geometry, any_hit):
    """``packet_closest_hit``/``packet_any_hit`` on CPU tensors are the
    plain walk over ``pack_bvh_geometry``'s tables: equal to
    ``intersect_bvh`` bit for bit, with a lane mask and finite maxt."""
    v, f, _, tree = geometry
    vt, ft = torch.tensor(v), torch.tensor(f).long()
    p0 = vt[ft[:, 0]]
    tables = pack_bvh_geometry(tree, torch.cat(
        [p0, vt[ft[:, 1]] - p0, vt[ft[:, 2]] - p0], 1))
    o, d, maxt = (torch.tensor(x) for x in _rays(v))
    active = torch.tensor(np.random.default_rng(1).random(len(o)) < 0.8)
    t_ref, prim_ref = bvh.intersect_bvh(tree, vt, ft, o, d, maxt, active,
                                        any_hit=any_hit)
    assert torch.isinf(t_ref[~active]).all()
    before = packet_closest_hit.launches, packet_any_hit.launches
    if any_hit:
        occ = packet_any_hit(tables, o, d, maxt, active)
        assert torch.equal(occ, torch.isfinite(t_ref))
        counts = {}
        packet_any_hit_plain(tables, o, d, maxt, active, counts=counts)
        assert counts["node_visits"] >= int(active.sum()) and counts["tests"]
    else:
        t, face = packet_closest_hit(tables, o, d, maxt, active)
        assert face.dtype == torch.int32
        assert torch.equal(t, t_ref) and torch.equal(face.long(), prim_ref)
    assert (packet_closest_hit.launches, packet_any_hit.launches) == before


def test_inactive_lanes_miss():
    v, f, _, _ = sphere_mesh(1)
    tree = bvh.build_bvh(v, f, device="cpu")
    o = torch.tensor([[0.0, 0.0, -3.0]] * 2)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    t, prim = bvh.intersect_bvh(tree, torch.tensor(v), torch.tensor(f).long(),
                                o, d, active=torch.tensor([True, False]))
    assert torch.isfinite(t[0]) and prim[0] >= 0
    assert torch.isinf(t[1]) and prim[1] == -1


def test_make_scene_builds_the_accel():
    """Above MAX_FACES faces make_scene builds the tree over the scene's
    geometry, and the bounding sphere matches the JAX package's."""
    jscene = jax_scene_with_ball(4, 4, 3, use_bvh=True)
    scene = big_scene(4, 4, subdiv=3, device="cpu")
    assert scene.accel.n_nodes == jscene.accel.bbox_lo.shape[0]
    np.testing.assert_array_equal(scene.accel.miss.numpy(),
                                  np.asarray(jscene.accel.miss))
    np.testing.assert_allclose(scene.scene_center,
                               np.asarray(jscene.scene_center), rtol=1e-6)
    assert scene.scene_radius == pytest.approx(float(jscene.scene_radius),
                                               rel=1e-6)
    assert big_scene(4, 4, subdiv=2, device="cpu").accel is None  # 356 faces


def test_leaf_slots_rise_in_dfs_order(geometry):
    """Leaves tile the leaf slots in DFS node order: ``first`` rises, each
    leaf starts where the one before it ends, and the tree is in DFS
    layout (an inner node's left child is the next node).  The two-child
    walk of the BVH kernels relies on that order: it visits leaves as
    the miss-link walk does, so equal t resolve to the same slot."""
    *_, tree = geometry
    leaf = tree.count > 0
    first, count = tree.first[leaf].long(), tree.count[leaf].long()
    assert first[0] == 0 and bool((first[1:] == first[:-1] + count[:-1]).all())
    assert int(first[-1] + count[-1]) == tree.prims.shape[0] - bvh.LEAF_SIZE
    inner = torch.nonzero(~leaf).flatten()
    assert bool((tree.miss[inner + 1] > inner + 1).all())


def _decode(link):
    """(record, None) of an inner child's link, (None, (first, count)) of
    a leaf's."""
    return (link, None) if link > 0 else (None, (~link >> 3, ~link & 7))


def test_node_pairs_hold_both_children(geometry):
    """Each record of the tree's ``node_pair`` table (``build_bvh``'s
    ``pack_node_pairs``) holds the boxes and links of the children n + 1
    and miss[n + 1] of its inner node n (record 0: the root and a NaN
    box), and ``depth`` is the tree's."""
    *_, tree = geometry
    table, depth = tree.node_pair, tree.depth
    assert table.dtype == torch.float32 and table.is_contiguous()
    boxes = table[:, :12].numpy()
    links = table.view(torch.int32)[:, 12:].numpy()
    lo, hi = tree.bbox_lo.numpy(), tree.bbox_hi.numpy()
    first, count = tree.first.numpy(), tree.count.numpy()
    miss = tree.miss.numpy()
    inner = np.nonzero(count == 0)[0]
    assert table.shape == (len(inner) + 1, 16)
    record = {int(n): k + 1 for k, n in enumerate(inner)}

    def expect(child):
        if count[child] == 0:
            return record[int(child)], None
        return None, (int(first[child]), int(count[child]))

    def box(c):
        return [lo[c, 0], hi[c, 0], lo[c, 1], hi[c, 1], lo[c, 2], hi[c, 2]]

    for k in range(len(inner) + 1):
        left = 0 if k == 0 else inner[k - 1] + 1
        got = boxes[k]
        np.testing.assert_array_equal(
            [got[0], got[1], got[2], got[3], got[8], got[9]], box(left))
        assert _decode(int(links[k, 0])) == expect(left)
        if k == 0:
            assert np.isnan(got[[4, 5, 6, 7, 10, 11]]).all()
            assert links[k, 1] == 0
            continue
        right = miss[left]
        np.testing.assert_array_equal(
            [got[4], got[5], got[6], got[7], got[10], got[11]], box(right))
        assert _decode(int(links[k, 1])) == expect(right)
    assert (links[:, 2:] == 0).all()

    def subtree_depth(n):
        return 0 if count[n] else 1 + max(subtree_depth(n + 1),
                                          subtree_depth(miss[n + 1]))

    assert depth == subtree_depth(0) > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_per_lane_counts(geometry, any_hit):
    """The walk's per-lane counts sum to its totals, inactive lanes count
    nothing, and a second walk adds to both."""
    v, f, _, tree = geometry
    o, d, maxt = (torch.tensor(x) for x in _rays(v, n=512))
    active = torch.tensor(np.random.default_rng(2).random(len(o)) < 0.8)
    leaf_tri = bvh.leaf_triangles(torch.tensor(v), torch.tensor(f).long(),
                                  tree.prims)
    counts = {}
    for walks in (1, 2):
        bvh.walk(tree, leaf_tri, o, d, maxt, active, any_hit=any_hit,
                 counts=counts, key="tests")
        lane = counts["per_lane"]["tests"]
        assert int(lane["node_visits"].sum()) == counts["node_visits"]
        assert int(lane["tests"].sum()) == counts["tests"] > 0
        assert bool((lane["node_visits"][active] >= walks).all())
        assert not lane["node_visits"][~active].any()
        assert not lane["tests"][~active].any()


def test_build_bvh_needs_a_device_choice():
    """build_bvh defaults to the GPU, as every entry point of the port:
    without one it raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    v = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bvh.build_bvh(v, np.arange(3).reshape(1, 3))


@pytest.mark.parametrize("finite_maxt", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_pair_walk_equals_walk(geometry, any_hit, finite_maxt):
    """The eager twin of csrc/bvh_pair_walk.cuh (nearer child first, a
    stack of put-off children) gives the miss-link walk's answers on the
    test meshes, bit for bit, with an 80 % lane mask: (t, slot) for the
    closest hit, occluded for any hit.  Its tie rule, the lowest slot
    among equal t, is the miss-link walk's first in DFS order."""
    v, f, _, tree = geometry
    o, d, maxt = (torch.tensor(x) for x in _rays(v))
    if not finite_maxt:
        maxt = torch.full_like(maxt, float("inf"))
    active = torch.tensor(np.random.default_rng(3).random(len(o)) < 0.8)
    leaf_tri = bvh.leaf_triangles(torch.tensor(v), torch.tensor(f).long(),
                                  tree.prims)
    plain, pair = {}, {}
    t_ref, s_ref = bvh.walk(tree, leaf_tri, o, d, maxt, active,
                            any_hit=any_hit, counts=plain)
    t, s = bvh.pair_walk(tree, leaf_tri, o, d, maxt, active, any_hit=any_hit,
                         counts=pair)
    hit = torch.isfinite(t_ref)
    assert 0.2 < float(hit[active].float().mean()) < 0.95
    assert not torch.isfinite(t[~active]).any() and (s[~active] == -1).all()
    if any_hit:
        assert torch.equal(torch.isfinite(t), hit)
    else:
        assert torch.equal(t, t_ref) and torch.equal(s, s_ref)
    # a record holds both children: fewer fetches than the boxes tested
    assert 0 < pair["record_visits"] < plain["node_visits"]
    assert pair["tests"] > 0


def test_pair_walk_rounding_case():
    """The one case where the two walks part: a ray meets T1, whose t
    rounds below the tnear of its leaf's box, and T2 of the other leaf at
    a t between the two.  The miss-link walk enters T1's leaf first (DFS
    order) and keeps T1; the two-child walk enters T2's nearer box first,
    then skips T1's, whose tnear lies beyond T2.  Their t differ by at
    most a few ulps, and every other ray gets the same answer."""
    tree, rows, o, d = rounding_tree()
    leaf_tri = pack_bvh_geometry(tree, rows).leaf_geo
    n = o.shape[0]
    maxt = torch.full((n,), float("inf"))
    active = torch.ones(n, dtype=torch.bool)
    t_ref, s_ref = bvh.walk(tree, leaf_tri, o, d, maxt, active)
    t, s = bvh.pair_walk(tree, leaf_tri, o, d, maxt, active)
    assert bool(torch.isfinite(t_ref).all())
    part = torch.nonzero(t != t_ref).flatten()
    assert part.numel() > 0
    # the miss-link walk: T1 (slot 0); the two-child walk: T2 (slot 2)
    assert (s_ref[part] == 0).all() and (s[part] == 2).all()
    ulps = t[part].view(torch.int32) - t_ref[part].view(torch.int32)
    assert ((ulps >= 1) & (ulps <= 4)).all()
    # T1's t lies below its box's tnear, T2's between them
    lo, hi = tree.bbox_lo[1], tree.bbox_hi[1]
    _, tnear = bvh._box_hit(*(x for k in range(3) for x in (lo[k], hi[k])),
                            *o[part].unbind(-1),
                            *bvh.safe_rcp(d[part]).unbind(-1), float("inf"))
    assert (t_ref[part] < t[part]).all() and (t[part] < tnear).all()
    # elsewhere the same t, and the same face unless the two are equal
    same = torch.ones(n, dtype=torch.bool)
    same[part] = False
    assert torch.equal(t[same], t_ref[same])
    tie = same & (s != s_ref)
    assert ((s_ref[tie] == 0) & (s[tie] == 2)).all()


def test_geometry_carries_the_pair_table(geometry):
    """``pack_bvh_geometry`` hands the kernels the tree's pair table and
    depth as ``build_bvh`` made them, and the route follows the depth:
    the two-child walk up to its stack, the miss-link walk beyond."""
    v, f, _, tree = geometry
    vt, ft = torch.tensor(v), torch.tensor(f).long()
    p0 = vt[ft[:, 0]]
    tables = pack_bvh_geometry(tree, torch.cat(
        [p0, vt[ft[:, 1]] - p0, vt[ft[:, 2]] - p0], 1))
    assert tables.node_pair is tree.node_pair and tables.depth == tree.depth
    assert tables.bvh().depth == tree.depth
    assert route_for(tree.depth) == route_for(PAIR_STACK) == "pair"
    assert route_for(PAIR_STACK + 1) == "miss_link"
