"""Two-level instancing: one group's geometry, many transforms
(mitsuba_tpu/models/instancing.py; reference shapegroup.cpp and
instance.cpp, whose Embree scene holds one sub-scene a group,
scene_embree.inl:113-160).

An ``InstancedGroup`` stores its object-space triangles once, with its
own tree above ``MAX_FACES`` faces (``ops/bvh.py::build_bvh``) and none
below, and the (I, 4, 4) ``to_world`` of its instances.  A ray meets the
group in candidate rounds:

1. every ray slab-tests the instances' world boxes, ``CHUNK`` boxes at a
   time (never an (N, I) array), and takes its nearest untested
   candidate whose entry t can still beat its best hit; the frontier key
   (entry t, instance id) makes each round progress;
2. each live ray is taken into its candidate's object space with the
   unnormalised direction d' = M^-1 d, which keeps world t, so one query
   of the group's triangles serves every instance at once: the brute
   kernel #1 (``intersect_packed``) on a group of at most ``MAX_FACES``
   faces, the BVH kernels #5 / #6 (``packet_closest_hit`` /
   ``packet_any_hit``) on a larger one, each on the live rays only;
3. the rounds end when no ray has a candidate left.  Each round reads
   the live count on the host (the JAX package's ``while_loop``
   condition); ``group_closest`` and ``group_any`` count their queries,
   their rounds in all and the most rounds of one query (``queries``,
   ``rounds``, ``max_rounds``; ``reset_round_counts`` sets them to 0).

The interaction (``instanced_si``) is rebuilt from the object-space hit
triangle under the instance's attached ``to_world`` (its normals under
the inverse transpose), so gradients reach the group's vertices and the
transforms; the per-lane gathers are ``ops/gather.py::gather_rows``,
whose backward repeats bit for bit.  ``to_object`` and the world boxes
are derived from ``to_world`` and the vertices whenever a group is made
or updated (``utils/params.py::update``), so a moved instance is never
tested against its old box (the JAX package keeps the boxes of
``create``).  Emitters inside groups are refused, as in the reference.
The TPU packing of the JAX groups (``pack_leaf_rows``, ``pack_mxu_rows``,
``refit_packet_bvh``) is not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.math import Frame, cross, dot, normalize, sqrt
from ..ops.bvh import BVH, build_bvh, refit_bvh
from ..ops.gather import gather_rows
from ..ops.intersect import ray_triangle
from ..ops.intersect_packed import intersect_packed, pack_triangles
from ..ops.megakernel import MAX_FACES
from ..ops.traverse import (pack_bvh_geometry, packet_any_hit,
                            packet_closest_hit)

CHUNK = 64       # instance boxes a step of the candidate scan


@dataclass
class InstancedGroup:
    """One shape group and its instances: the object-space geometry
    once, the transforms differentiable.  ``to_object``, ``world_lo`` and
    ``world_hi`` are derived (``__post_init__``), never set."""

    vertices: torch.Tensor     # (V, 3) object space
    faces: torch.Tensor        # (F, 3) int64
    normals: torch.Tensor      # (V, 3), zeros for flat submeshes
    uvs: torch.Tensor          # (V, 2)
    fshape_g: torch.Tensor     # (F,) int64 submesh of each face
    fsmooth: torch.Tensor      # (F,) float32 1.0 for smooth shading
    to_world: torch.Tensor     # (I, 4, 4)
    accel: BVH | None = None   # the group's tree above MAX_FACES faces
    n_submeshes: int = 0
    bsdf_of_submesh: tuple = ()
    emitter_of_submesh: tuple = ()
    id: str = "group"
    to_object: torch.Tensor = field(init=False)   # (I, 4, 4)
    world_lo: torch.Tensor = field(init=False)    # (I, 3) detached
    world_hi: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.to_object = torch.linalg.inv(self.to_world)
        with torch.no_grad():
            v = self.vertices.detach()
            lo, hi = v.amin(dim=0), v.amax(dim=0)
            sel = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1]
                                for i in range(8)], dtype=torch.bool,
                               device=v.device)
            corners = torch.where(sel, hi, lo)                  # (8, 3)
            m = self.to_world.detach()
            cw = dot(m[:, None, :3, :3], corners[None, :, None, :]) \
                + m[:, None, :3, 3]                              # (I, 8, 3)
            self.world_lo = cw.amin(dim=1)
            self.world_hi = cw.amax(dim=1)

    @property
    def n_inst(self) -> int:
        return int(self.to_world.shape[0])

    @staticmethod
    def create(submeshes, transforms, id="group", device=None):
        """A group of ``submeshes`` (``Mesh`` es in object space) under
        ``transforms`` ((I, 4, 4) or a list of 4 x 4 ``to_world``), on
        ``device`` (default: the GPU); builds the group's tree on the
        host above ``MAX_FACES`` faces, as the reference builds a group's
        Embree scene once (scene_embree.inl:113)."""
        from ..device import resolve_device

        device = resolve_device(device)
        offs = np.cumsum([0] + [int(m.vertices.shape[0]) for m in submeshes])
        v = torch.cat([m.vertices.to(device) for m in submeshes])
        f = torch.cat([m.faces.to(device).long() + int(offs[i])
                       for i, m in enumerate(submeshes)])
        nrm = torch.cat([m.normals.to(device) if m.normals is not None
                         else torch.zeros_like(m.vertices, device=device)
                         for m in submeshes])
        uv = torch.cat([m.uvs.to(device) if m.uvs is not None
                        else torch.zeros((m.vertices.shape[0], 2),
                                         device=device)
                        for m in submeshes])
        counts = [int(m.faces.shape[0]) for m in submeshes]
        fshape = torch.repeat_interleave(
            torch.arange(len(submeshes), device=device),
            torch.tensor(counts, device=device))
        fsmooth = torch.repeat_interleave(
            torch.tensor([float(m.normals is not None) for m in submeshes],
                         device=device), torch.tensor(counts, device=device))
        M = torch.as_tensor(np.stack([np.asarray(t, np.float32)
                                      for t in transforms]), device=device)
        accel = None
        if int(f.shape[0]) > MAX_FACES:
            accel = build_bvh(v.detach().cpu().numpy(), f.cpu().numpy(),
                              device=device)
        return InstancedGroup(
            vertices=v, faces=f, normals=nrm, uvs=uv, fshape_g=fshape,
            fsmooth=fsmooth, to_world=M, accel=accel,
            n_submeshes=len(submeshes),
            bsdf_of_submesh=tuple(int(m.bsdf_index) for m in submeshes),
            emitter_of_submesh=tuple(int(m.emitter_index) for m in submeshes),
            id=id)

    @property
    def nbytes(self) -> int:
        """Device bytes of the group: its geometry, transforms, boxes and
        tree."""
        ts = [self.vertices, self.faces, self.normals, self.uvs,
              self.fshape_g, self.fsmooth, self.to_world, self.to_object,
              self.world_lo, self.world_hi]
        if self.accel is not None:
            ts += [self.accel.bbox_lo, self.accel.bbox_hi, self.accel.first,
                   self.accel.count, self.accel.miss, self.accel.prims,
                   self.accel.node_pair]
        return sum(t.numel() * t.element_size() for t in ts)


def group_shading_ctx(g: InstancedGroup):
    """The attached (F, 26) rows ``instanced_si`` gathers: p0 p1 p2 | n0
    n1 n2 | uv0 uv1 uv2 | submesh smooth, in object space (the scene's
    ``tri_data`` layout)."""
    F = int(g.faces.shape[0])
    idx = g.faces.reshape(-1)

    def corners(x):
        return gather_rows(x, idx).reshape(F, -1)

    return {"tri_data": torch.cat([
        corners(g.vertices), corners(g.normals), corners(g.uvs),
        g.fshape_g.to(torch.float32)[:, None], g.fsmooth[:, None]], dim=-1)}


def group_trace_ctx(g: InstancedGroup, ctx):
    """The group's ``group_shading_ctx`` ``ctx`` plus the query's tables,
    from detached vertices: ``pack_triangles`` for #1 without a tree, the
    refitted tree's ``pack_bvh_geometry`` for #5 / #6 with one."""
    ctx = dict(ctx)
    v = g.vertices.detach()
    if g.accel is None:
        ctx["tris_packed"] = pack_triangles(v, g.faces)
    else:
        p = v[g.faces]
        geo = torch.cat([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1)
        ctx["bvh"] = pack_bvh_geometry(refit_bvh(g.accel, v), geo)
    return ctx


def _transform_rays(minv, o, d):
    """Per-lane (N, 4, 4) inverses applied to points and directions; the
    direction is not normalised, so t stays the world t."""
    R = minv[:, :3, :3]
    o2 = dot(R, o[:, None, :]) + minv[:, :3, 3]
    d2 = dot(R, d[:, None, :])
    return o2.contiguous(), d2.contiguous()


def _inv_dir(d):
    eps = 1e-30
    return 1.0 / torch.where(torch.abs(d) > eps, d,
                             torch.where(d >= 0, eps, -eps))


def _slab_chunk(o, inv_d, lo, hi, maxt):
    """(N, 3) rays against (C, 3) boxes: (entry t (N, C), hit (N, C))."""
    tn = tf = None
    for a in range(3):
        t0 = (lo[None, :, a] - o[:, None, a]) * inv_d[:, None, a]
        t1 = (hi[None, :, a] - o[:, None, a]) * inv_d[:, None, a]
        lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo_a if tn is None else torch.maximum(tn, lo_a)
        tf = hi_a if tf is None else torch.minimum(tf, hi_a)
    tn = torch.clamp(tn, min=0.0)
    return tn, (tn <= tf) & (tn < maxt[:, None])


def select_candidate(g, o, inv_d, best_t, f_t, f_i, active):
    """Each ray's nearest untested instance in frontier order: the box
    whose (entry t, id) comes first after (f_t, f_i) among those it
    enters before ``best_t``; (-1, inf) for none.  The boxes are scanned
    ``CHUNK`` at a time with a running minimum."""
    n = o.shape[0]
    dev = o.device
    tbest = torch.full((n,), math.inf, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, g.n_inst, CHUNK):
        c1 = min(c0 + CHUNK, g.n_inst)
        ids = torch.arange(c0, c1, device=dev)
        tn, hit = _slab_chunk(o, inv_d, g.world_lo[c0:c1], g.world_hi[c0:c1],
                              best_t)
        after = (tn > f_t[:, None]) | ((tn == f_t[:, None])
                                       & (ids[None, :] > f_i[:, None]))
        cand = hit & after & active[:, None]
        tm = torch.where(cand, tn, math.inf)
        cmin = tm.amin(dim=1)
        imin = torch.where(cand & (tn == cmin[:, None]), ids[None, :],
                           1 << 30).amin(dim=1)
        take = (cmin < tbest) | ((cmin == tbest) & (imin < ibest))
        tbest = torch.where(take, cmin, tbest)
        ibest = torch.where(take, imin, ibest)
    return torch.where(torch.isfinite(tbest), ibest, -1), tbest


def group_query(ctx_g, o, d, maxt, closest):
    """One query of the group's object-space triangles for the rays
    (o, d) (all live): (t, face) for the closest hit, else the occluded
    mask.  #1 without a tree, #5 / #6 with one."""
    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    maxt = maxt.contiguous()
    if "bvh" in ctx_g:
        if closest:
            t, face = packet_closest_hit(ctx_g["bvh"], o, d, maxt, active)
            return t, face.long()
        return packet_any_hit(ctx_g["bvh"], o, d, maxt, active)
    t, prim, _, _ = intersect_packed(ctx_g["tris_packed"], o, d, maxt, active)
    return (t, prim.long()) if closest else torch.isfinite(t)


def group_closest(g, ctx_g, o, d, best_t, active):
    """The closest hit of (o, d) on the group's instances within
    ``best_t``, in candidate rounds: (t, face in the group, instance),
    t = inf and instance -1 where none is closer."""
    n = o.shape[0]
    dev = o.device
    inv_d = _inv_dir(d)
    to_object = g.to_object.detach()
    chosen, tkey = select_candidate(
        g, o, inv_d, torch.where(active, best_t, 0.0),
        torch.full((n,), -math.inf, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev), active)
    bt = best_t.clone()
    bp = torch.zeros(n, dtype=torch.int64, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    live = torch.nonzero(chosen >= 0).squeeze(1)
    rounds = 0
    while live.numel():
        rounds += 1
        c = chosen[live]
        o2, d2 = _transform_rays(to_object[c], o[live], d[live])
        bt_l = bt[live]
        t, prim = group_query(ctx_g, o2, d2, bt_l, True)
        closer = torch.isfinite(t) & (t < bt_l)
        bt[live] = torch.where(closer, t, bt_l)
        bp[live] = torch.where(closer, prim, bp[live])
        bi[live] = torch.where(closer, c, bi[live])
        c, k = select_candidate(g, o[live], inv_d[live], bt[live], tkey[live],
                                c, torch.ones_like(closer))
        chosen[live], tkey[live] = c, k
        live = live[c >= 0]
    _count_rounds(group_closest, rounds)
    return torch.where(bi >= 0, bt, math.inf), bp, bi


def group_any(g, ctx_g, o, d, maxt, active):
    """Whether a ray (o, d) meets any instance of the group within
    ``maxt`` (N,) bool, in candidate rounds that end at a ray's first
    occluder."""
    n = o.shape[0]
    dev = o.device
    inv_d = _inv_dir(d)
    to_object = g.to_object.detach()
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    chosen, tkey = select_candidate(
        g, o, inv_d, torch.where(active, maxt, 0.0),
        torch.full((n,), -math.inf, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev), active)
    live = torch.nonzero(chosen >= 0).squeeze(1)
    rounds = 0
    while live.numel():
        rounds += 1
        c = chosen[live]
        o2, d2 = _transform_rays(to_object[c], o[live], d[live])
        hit = group_query(ctx_g, o2, d2, maxt[live], False)
        occ[live] = hit
        free = ~hit
        c, k = select_candidate(g, o[live], inv_d[live],
                                torch.where(free, maxt[live], 0.0),
                                tkey[live], c, free)
        chosen[live], tkey[live] = c, k
        live = live[c >= 0]
    _count_rounds(group_any, rounds)
    return occ


def _count_rounds(query, rounds):
    query.queries += 1
    query.rounds += rounds
    query.max_rounds = max(query.max_rounds, rounds)


def reset_round_counts():
    for query in (group_closest, group_any):
        query.queries = query.rounds = query.max_rounds = 0


reset_round_counts()


def instanced_si(scene, pi, ray, ctx, mode, si):
    """``si`` with the lanes that hit an instance rebuilt: the object-
    space face transformed by the instance's attached ``to_world`` (its
    normals by the inverse transpose), in ``mode`` as the scene's mesh
    branch (instance.cpp's compute_surface_interaction), so gradients
    reach the group's vertices, normals, uvs and the transforms."""
    slot0 = scene._instance_base()
    for g, ctx_g in zip(scene.instances, ctx["inst"]):
        on_g = (pi.inst_index >= 0) & (pi.shape_index >= slot0) \
            & (pi.shape_index < slot0 + g.n_submeshes)
        slot0 += g.n_submeshes
        idx = torch.nonzero(on_g).squeeze(1)
        if not idx.numel():
            continue
        prim, inst = pi.prim_index[idx], pi.inst_index[idx]
        td = gather_rows(ctx_g["tri_data"], prim)
        M = gather_rows(g.to_world.reshape(-1, 16), inst).reshape(-1, 4, 4)
        Minv = gather_rows(g.to_object.reshape(-1, 16), inst).reshape(-1, 4, 4)
        if mode == "detach_shape":
            td, M, Minv = td.detach(), M.detach(), Minv.detach()
        R, tr = M[:, :3, :3], M[:, :3, 3]
        Rit = Minv[:, :3, :3].transpose(1, 2)

        def xf(p):
            return dot(R, p[:, None, :]) + tr

        def xfn(v):
            return dot(Rit, v[:, None, :])

        p0, p1, p2 = xf(td[:, 0:3]), xf(td[:, 3:6]), xf(td[:, 6:9])
        n0, n1, n2 = xfn(td[:, 9:12]), xfn(td[:, 12:15]), xfn(td[:, 15:18])
        uv0, uv1, uv2 = td[:, 18:20], td[:, 20:22], td[:, 22:24]
        smooth = td[:, 25] > 0.5
        o, d = ray.o[idx], ray.d[idx]
        t, u, v, _ = ray_triangle(o, d, p0, p1, p2)
        ok = torch.isfinite(t)
        t = torch.where(ok, t, pi.t[idx])
        u = torch.clamp(torch.where(ok, u, 0.0), 0.0, 1.0)
        v = torch.clamp(torch.where(ok, v, 0.0), 0.0, 1.0)
        if mode == "follow_shape":
            u, v = u.detach(), v.detach()
        b0 = 1.0 - u - v
        p = p0 * b0[:, None] + p1 * u[:, None] + p2 * v[:, None]
        if mode == "follow_shape":
            t = sqrt(torch.clamp(dot(p - o, p - o), min=1e-30)
                           / torch.clamp(dot(d, d), min=1e-30))
        ng = normalize(cross(p1 - p0, p2 - p0))
        ns = normalize(n0 * b0[:, None] + n1 * u[:, None] + n2 * v[:, None])
        sh_n = torch.where(smooth[:, None], ns, ng)
        uv = uv0 * b0[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
        s, tt, _ = Frame.from_normal(sh_n)
        wi = Frame.to_local((s, tt, sh_n), -d)
        for name, val in (("t", t), ("p", p), ("n", ng), ("sh_n", sh_n),
                          ("sh_s", s), ("sh_t", tt), ("uv", uv), ("wi", wi),
                          ("shape_index", pi.shape_index[idx]),
                          ("prim_index", prim)):
            setattr(si, name, getattr(si, name).index_copy(0, idx, val))
    si.inst_index = pi.inst_index
    return si
