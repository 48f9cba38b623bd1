"""Host BVH build and the plain stackless walk (mitsuba_tpu/ops/bvh.py).

- **Build**: the binned-SAH builder ``csrc/bvh_builder.cpp`` (the port's
  copy of ``mitsuba_tpu/native/bvh_builder.cpp``), compiled with g++ at
  first use into ``_build/`` and loaded with ctypes.  Leaf size 4, nodes
  flattened in DFS order with threaded *miss links*: the hit successor
  of an inner node is ``node + 1``; ``miss[node]`` is where the walk goes
  when the box is missed or after a leaf, -1 to exit.  The tree equals
  the JAX package's ``build_bvh(..., method="sah")`` array for array.
- **Walk**: ``walk`` is the plain PyTorch counterpart of
  ``intersect_bvh`` and of csrc/bvh_walk.cuh: every lane carries only a
  node cursor, leaves are visited in DFS order and a face wins only with
  a strictly smaller t, so ties resolve the same way in all three (the
  BVH megakernels' two-child walk, csrc/bvh_pair_walk.cuh, keeps the
  lowest slot among equal t, the first in DFS order).  Lanes are
  compacted as they finish.
- **Pair walk**: ``pair_walk`` is the eager twin of csrc/bvh_pair_walk.cuh
  (``PairQuery::walk``, the walk of the BVH megakernels and of the
  wavefront's queries on trees up to its stack cap) over ``node_pair``,
  step for step, so the CPU can hold its visiting order against
  ``walk``'s answers.

Refit (``refit_bvh``) is not ported: primal geometry is static.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..core.math import safe_rcp
from ..device import resolve_device
from . import _build
from .intersect import tri_test

LEAF_SIZE = 4
PAIR_COLS = 16  # both children's boxes (12 floats) and links (2 int32, 2 pad)


@dataclass
class BVH:
    bbox_lo: torch.Tensor   # (M, 3) float32
    bbox_hi: torch.Tensor   # (M, 3) float32
    first: torch.Tensor     # (M,) int32, start into prims for leaves
    count: torch.Tensor     # (M,) int32, prim count (0 = inner node)
    miss: torch.Tensor      # (M,) int32, miss link (-1 = exit)
    prims: torch.Tensor     # (F + LEAF_SIZE,) int32 face ids, -1 padded
    # build_bvh's pack_node_pairs: the BVH megakernels' walk table and the
    # tree's depth
    node_pair: torch.Tensor | None = None   # (R, PAIR_COLS) float32
    depth: int = 0

    @property
    def n_nodes(self) -> int:
        return int(self.bbox_lo.shape[0])


def _builder():
    fn = _build.load("bvh_builder").build_bvh_sah
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, i, p, i, i, p, p, p, p, p, p]
        fn.restype = i
    return fn


def build_bvh(vertices, faces, leaf_size: int = LEAF_SIZE,
              device=None) -> BVH:
    """SAH build on the host from (V, 3) vertices and (F, 3) faces (numpy
    arrays), returned as tensors on ``device`` (default: the GPU; pass
    ``device="cpu"`` for the CPU).  Raises if the SAH library cannot be
    compiled or fails."""
    device = resolve_device(device)
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    nf = int(f.shape[0])
    max_nodes = max(2 * nf, 1)
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    prims = np.empty(nf + leaf_size, np.int32)
    m = _builder()(v.ctypes.data, v.shape[0], f.ctypes.data, nf, leaf_size,
                   lo.ctypes.data, hi.ctypes.data, first.ctypes.data,
                   count.ctypes.data, miss.ctypes.data, prims.ctypes.data)
    if m <= 0:
        raise RuntimeError(f"BVH build failed for {nf} faces")

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    node_pair, depth = pack_node_pairs(lo[:m], hi[:m], first[:m], count[:m],
                                       miss[:m])
    return BVH(bbox_lo=t(lo[:m]), bbox_hi=t(hi[:m]), first=t(first[:m]),
               count=t(count[:m]), miss=t(miss[:m]), prims=t(prims),
               node_pair=t(node_pair), depth=depth)


def pack_node_pairs(lo, hi, first, count, miss):
    """The walk table of the BVH megakernels (csrc/bvh_pair_walk.cuh), and
    the tree's depth (the most inner nodes on a path from the root to a
    leaf), from the tree's numpy arrays; once a tree, on the host.

    Nodes are in DFS order: the children of inner node n are n + 1 and
    miss[n + 1].  Record 0 is a super-root whose left child is the root
    and whose right box is NaN (no ray hits it); record k >= 1 is the k-th
    inner node in DFS order.  Row of a record: (L.lo.x, L.hi.x, L.lo.y,
    L.hi.y, R.lo.x, R.hi.x, R.lo.y, R.hi.y, L.lo.z, L.hi.z, R.lo.z, R.hi.z)
    float32, then the two children's links and two zeros as int32 bits:
    an inner child's record, or ~(first << 3 | count) for a leaf (always
    negative)."""
    first, count, miss = (np.asarray(x, np.int64) for x in (first, count,
                                                            miss))
    if count.max() > 7:
        raise ValueError("pack_node_pairs: a leaf holds more than 7 faces")
    inner = count == 0
    link = np.where(inner, np.cumsum(inner), ~((first << 3) | count))
    left = np.concatenate([[0], np.nonzero(inner)[0] + 1])
    right = miss[left[1:]]
    nan = np.full((1, 3), np.nan, np.float32)
    llo, lhi = lo[left], hi[left]
    rlo, rhi = np.concatenate([nan, lo[right]]), np.concatenate([nan, hi[right]])
    table = np.zeros((left.shape[0], PAIR_COLS), np.float32)
    table[:, :12] = np.stack([llo[:, 0], lhi[:, 0], llo[:, 1], lhi[:, 1],
                              rlo[:, 0], rhi[:, 0], rlo[:, 1], rhi[:, 1],
                              llo[:, 2], lhi[:, 2], rlo[:, 2], rhi[:, 2]], 1)
    links = table.view(np.int32)
    links[:, 12] = link[left]
    links[1:, 13] = link[right]
    depth, level = 0, np.zeros(1, np.int64)
    while True:
        level = level[count[level] == 0]
        if level.size == 0:
            return table, depth
        level = np.concatenate([level + 1, miss[level + 1]])
        depth += 1


def slab_test(ox, oy, oz, ix, iy, iz, lo, hi, tmax):
    """Ray-AABB test (ops/bvh.py ``_slab_test``) on per-lane components
    and (N, 3) boxes; ``i*`` are ``safe_rcp`` inverse directions, so no
    product is 0 * inf.  Returns bool (N,)."""
    t0x, t1x = (lo[:, 0] - ox) * ix, (hi[:, 0] - ox) * ix
    t0y, t1y = (lo[:, 1] - oy) * iy, (hi[:, 1] - oy) * iy
    t0z, t1z = (lo[:, 2] - oz) * iz, (hi[:, 2] - oz) * iz
    tnear = torch.clamp(torch.maximum(torch.maximum(
        torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z)), min=0.0)
    tfar = torch.minimum(torch.minimum(torch.minimum(
        torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z)), tmax)
    return tnear <= tfar


def leaf_triangles(vertices, faces, prims):
    """(P, 9) [p0 | e1 | e2] rows in leaf-slot order (slot s holds face
    ``prims[s]``; padding slots are zero)."""
    f = faces[prims.clamp(min=0).long()]
    p0 = vertices[f[:, 0]]
    rows = torch.cat([p0, vertices[f[:, 1]] - p0, vertices[f[:, 2]] - p0], 1)
    return torch.where((prims >= 0)[:, None], rows, 0.0)


def walk(bvh: BVH, leaf_tri, o, d, maxt, active, any_hit: bool = False,
         counts: dict | None = None, key: str = "tests"):
    """Miss-link walk over (N, 3) rays: closest hit, or with ``any_hit``
    the first hit within ``maxt`` after which the lane stops.

    ``leaf_tri`` holds at least the [p0 | e1 | e2] columns of each leaf
    slot.  Returns (t, slot): t = inf and slot = -1 where nothing was
    hit; ``bvh.prims[slot]`` is the face.  When ``counts`` is a dict it
    receives ``node_visits`` (boxes tested) and ``key`` (triangle tests;
    an any-hit leaf stops at its first occluder), summed over the lanes,
    and the same per lane: ``counts["per_lane"][key]`` is a dict of two
    (N,) int64 tensors, ``node_visits`` and ``tests``.  Each adds to what
    the dict holds.
    """
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(active).flatten()
    inv = safe_rcp(d)
    ox, oy, oz = o[lanes].unbind(-1)
    dx, dy, dz = d[lanes].unbind(-1)
    ix, iy, iz = inv[lanes].unbind(-1)
    mx = maxt[lanes]
    bt, bs = best_t[lanes], best_s[lanes]
    node = torch.zeros_like(lanes)
    track = counts is not None
    lane_visits = torch.zeros(n if track else 0, dtype=torch.int64,
                              device=dev)
    lane_tests = torch.zeros_like(lane_visits)
    first, count, miss = bvh.first.long(), bvh.count.long(), bvh.miss.long()
    j4 = torch.arange(LEAF_SIZE, device=dev)
    while lanes.numel():
        if track:
            lane_visits[lanes] += 1
        hit = slab_test(ox, oy, oz, ix, iy, iz, bvh.bbox_lo[node],
                        bvh.bbox_hi[node], torch.minimum(bt, mx))
        cnt = count[node]
        leaf = torch.nonzero(hit & (cnt > 0)).flatten()
        if leaf.numel():
            slots = first[node[leaf]][:, None] + j4            # (K, 4)
            valid = j4 < cnt[leaf][:, None]
            g = leaf_tri[torch.where(valid, slots, 0)]          # (K, 4, C)
            h, t = tri_test(*g[..., :9].unbind(-1),
                            *(c[leaf][:, None] for c in (ox, oy, oz,
                                                         dx, dy, dz)),
                            mx[leaf][:, None])
            h = h & valid
            lt, ls = bt[leaf], bs[leaf]
            if any_hit:
                stop = h.any(dim=1)
                jfirst = torch.argmax(h.to(torch.int8), dim=1)
                if track:
                    lane_tests[lanes[leaf]] += torch.where(stop, jfirst + 1,
                                                           cnt[leaf])
                lt = torch.where(stop, t.gather(1, jfirst[:, None])[:, 0], lt)
                ls = torch.where(stop, slots.gather(1, jfirst[:, None])[:, 0],
                                 ls)
            else:
                if track:
                    lane_tests[lanes[leaf]] += valid.sum(1)
                for j in range(LEAF_SIZE):
                    win = h[:, j] & (t[:, j] < lt)
                    lt = torch.where(win, t[:, j], lt)
                    ls = torch.where(win, slots[:, j], ls)
            bt = bt.index_put((leaf,), lt)
            bs = bs.index_put((leaf,), ls)
        node = torch.where(hit & (cnt == 0), node + 1, miss[node])
        if any_hit:
            node = torch.where(torch.isfinite(bt), -1, node)
        keep = node >= 0
        if not bool(keep.all()):
            done = ~keep
            best_t[lanes[done]] = bt[done]
            best_s[lanes[done]] = bs[done]
            (lanes, node, ox, oy, oz, dx, dy, dz, ix, iy, iz, mx, bt, bs) = (
                x[keep] for x in (lanes, node, ox, oy, oz, dx, dy, dz,
                                  ix, iy, iz, mx, bt, bs))
    if track:
        counts["node_visits"] = (counts.get("node_visits", 0)
                                 + int(lane_visits.sum()))
        counts[key] = counts.get(key, 0) + int(lane_tests.sum())
        per_lane = counts.setdefault("per_lane", {}).setdefault(
            key, {"node_visits": 0, "tests": 0})
        per_lane["node_visits"] = per_lane["node_visits"] + lane_visits
        per_lane["tests"] = per_lane["tests"] + lane_tests
    return best_t, best_s


def _box_hit(lox, hix, loy, hiy, loz, hiz, ox, oy, oz, ix, iy, iz, lim):
    """csrc/bvh_pair_walk.cuh ``box_hit`` on per-lane components: (hit,
    tnear), hit iff the ray meets the box (tnear <= its tfar) and
    tnear <= lim.  ``fmin``/``fmax`` are CUDA's fminf/fmaxf, which drop a
    NaN operand."""
    t0x, t1x = (lox - ox) * ix, (hix - ox) * ix
    t0y, t1y = (loy - oy) * iy, (hiy - oy) * iy
    t0z, t1z = (loz - oz) * iz, (hiz - oz) * iz
    fmin, fmax = torch.fmin, torch.fmax
    tnear = fmax(fmax(fmax(fmin(t0x, t1x), fmin(t0y, t1y)), fmin(t0z, t1z)),
                 torch.zeros_like(t0x))
    tfar = fmin(fmin(fmax(t0x, t1x), fmax(t0y, t1y)), fmax(t0z, t1z))
    return (tnear <= tfar) & (tnear <= lim), tnear


def pair_walk(bvh: BVH, leaf_tri, o, d, maxt, active, any_hit: bool = False,
              counts: dict | None = None):
    """The two-child-box walk of csrc/bvh_pair_walk.cuh (``PairQuery::walk``)
    over ``bvh.node_pair``, step for step, on (N, 3) rays: closest hit, or
    with ``any_hit`` the first hit within ``maxt``.

    A lane visits a record (both children's boxes tested with ``box_hit``
    against min(best, maxt); where both are hit the nearer goes next, the
    left on a tie, and the other waits on the lane's stack with its
    tnear; a leaf child's triangles are tested at once), or, with no
    record to visit, pops the last child put off and takes it only if
    its tnear <= min(best, maxt).  A leaf keeps the least (t, slot): a
    triangle hit within the best wins with a smaller t, or with an equal
    t and a lower slot.  The closest hit beyond ``maxt`` is dropped at
    the end, as csrc/traverse.cu does.  ``leaf_tri`` as in ``walk``.

    Returns (t, slot) as ``walk`` does.  When ``counts`` is a dict,
    ``record_visits`` (records fetched) and ``tests`` (triangle tests; an
    any-hit leaf stops at its first occluder) are added to it."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(active).flatten()
    inv = safe_rcp(d)
    ray = [x[lanes] for x in (*o.unbind(-1), *d.unbind(-1), *inv.unbind(-1),
                              maxt)]
    k = lanes.numel()
    bt = torch.full((k,), float("inf"), device=dev)
    bs = torch.full((k,), -1, dtype=torch.int64, device=dev)
    rec = torch.zeros(k, dtype=torch.int64, device=dev)  # -1: none to visit
    depth = max(bvh.depth, 1) + 1
    st_link = torch.zeros((k, depth), dtype=torch.int64, device=dev)
    st_t = torch.zeros((k, depth), device=dev)
    sp = torch.zeros(k, dtype=torch.int64, device=dev)
    box = bvh.node_pair[:, :12]
    link = bvh.node_pair.view(torch.int32)[:, 12:14].long()
    visits = tests = 0

    def leaf(sel, lk, stop):
        """Test the leaves ``lk`` of lanes ``sel`` (PairQuery::leaf);
        marks in ``stop`` the any-hit lanes that hit."""
        nonlocal tests
        first, count = (~lk) >> 3, (~lk) & 7
        oxyz = [x[sel] for x in ray[:6]]
        lt, ls = bt[sel], bs[sel]
        hit_any = torch.zeros_like(sel, dtype=torch.bool)
        for j in range(int(count.max())):
            valid = (j < count) & ~hit_any
            tests += int(valid.sum())
            sj = first + j
            g = leaf_tri[torch.where(valid, sj, 0)][:, :9].unbind(-1)
            h, t = tri_test(*g, *oxyz, ray[9][sel] if any_hit else lt)
            if any_hit:
                win = valid & h
                hit_any |= win
            else:
                win = valid & h & ((t < lt) | ((t == lt) & (sj < ls)))
            lt = torch.where(win, t, lt)
            ls = torch.where(win, sj, ls)
        bt[sel], bs[sel] = lt, ls
        stop[sel] |= hit_any

    while k:
        stop = torch.zeros(k, dtype=torch.bool, device=dev)
        visit = torch.nonzero(rec >= 0).flatten()
        pop = torch.nonzero((rec < 0) & (sp > 0)).flatten()
        if visit.numel():
            visits += visit.numel()
            r = rec[visit]
            b = box[r].unbind(-1)
            ox, oy, oz, ix, iy, iz = (ray[j][visit] for j in (0, 1, 2, 6, 7, 8))
            lim = torch.fmin(bt[visit], ray[9][visit])
            hl, tl = _box_hit(*b[0:4], b[8], b[9], ox, oy, oz, ix, iy, iz, lim)
            hr, tr = _box_hit(*b[4:8], b[10], b[11], ox, oy, oz, ix, iy, iz,
                              lim)
            ll, lr = link[r, 0], link[r, 1]
            right_first = hl & hr & (tr < tl)
            nxt = torch.where(hl, ll, torch.where(hr, lr, 0))
            both = torch.nonzero(hl & hr).flatten()
            if both.numel():
                lane, rf = visit[both], right_first[both]
                st_link[lane, sp[lane]] = torch.where(rf, ll[both], lr[both])
                st_t[lane, sp[lane]] = torch.where(rf, tl[both], tr[both])
                sp[lane] += 1
            nxt = torch.where(right_first, lr, nxt)
            rec[visit] = torch.where(nxt > 0, nxt, -1)
            to_leaf = nxt < 0
            if bool(to_leaf.any()):
                leaf(visit[to_leaf], nxt[to_leaf], stop)
        if pop.numel():
            sp[pop] -= 1
            e_link, e_t = st_link[pop, sp[pop]], st_t[pop, sp[pop]]
            take = e_t <= torch.fmin(bt[pop], ray[9][pop])
            rec[pop] = torch.where(take & (e_link > 0), e_link, -1)
            to_leaf = take & (e_link < 0)
            if bool(to_leaf.any()):
                leaf(pop[to_leaf], e_link[to_leaf], stop)
        done = stop | ((rec < 0) & (sp == 0))
        if bool(done.any()):
            best_t[lanes[done]] = bt[done]
            best_s[lanes[done]] = bs[done]
            keep = ~done
            lanes, bt, bs, rec, st_link, st_t, sp = (
                x[keep] for x in (lanes, bt, bs, rec, st_link, st_t, sp))
            ray = [x[keep] for x in ray]
            k = lanes.numel()
    if not any_hit:
        hit = (best_s >= 0) & (best_t <= maxt)
        best_t = torch.where(hit, best_t, float("inf"))
        best_s = torch.where(hit, best_s, -1)
    if counts is not None:
        counts["record_visits"] = counts.get("record_visits", 0) + visits
        counts["tests"] = counts.get("tests", 0) + tests
    return best_t, best_s


def intersect_bvh(bvh: BVH, vertices, faces, o, d, maxt=None, active=None,
                  any_hit: bool = False):
    """Closest-hit (or any-hit) query over (N, 3) rays against the mesh
    (vertices, faces) the tree was built on, as ``intersect_bvh`` of the
    JAX package.  Returns (t, prim): t = inf and prim = -1 on a miss; for
    any-hit, t is finite where the ray is occluded within ``maxt``."""
    n = o.shape[0]
    if maxt is None:
        maxt = torch.full((n,), float("inf"), device=o.device)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=o.device)
    t, slot = walk(bvh, leaf_triangles(vertices, faces, bvh.prims), o, d,
                   maxt, active, any_hit=any_hit)
    prim = torch.where(slot >= 0, bvh.prims.long()[slot.clamp(min=0)], -1)
    return t, prim
