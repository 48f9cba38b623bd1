"""Silhouette projection: the mesh walk, the Newton jump and their hybrid
(mitsuba_tpu/models/integrators/projection.py; reference
``ProjectOperation``, ad/projective.py:586-830, and
``Mesh::primitive_silhouette_projection``, mesh.cpp:1036-1177).

Given a seed surface point and a viewpoint, these operations move the
point onto a nearby mesh silhouette edge as seen from the viewpoint: an
edge where a front-facing and a back-facing triangle meet, or an open
boundary edge.  ``project_seed_points`` seeds the shadow term's octree
warm-up with such points (``indirect_boundary_grads(...,
guiding="projective")``): light-side rays walked onto the edges they
graze, instead of uniform points of the sample cube.

The walk takes a fixed number of steps over all lanes: each step
gathers the three neighbouring faces and applies the angular heuristic;
a lane already on a silhouette carries its result through, and the last
successful step wins.  The topology (each directed edge's opposite face,
the reference's ``m_E2E``) is built once on the host in numpy.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ...core import rng
from ...core.math import Frame, cross, dot, sqrt
from ...core.records import Ray
from ...core.warp import square_to_cosine_hemisphere
from .guiding import UniformDistr

# RNG dimension block (disjoint from the path's and the boundary's)
DIM_PROJ = 8300
# the seed salt of the light-side seeding pass
_SEED_SALT = 0x9E37B9


@dataclass
class FaceAdjacency:
    """Per-face directed-edge topology (mesh.h m_E2E): slot k of face f is
    the edge (v_k, v_{k+1 mod 3}); ``neighbors`` holds the face on its
    other side (-1: an open boundary) and ``edge_id`` the edge's row in the
    scene's ``EdgeTable``.  int64 tensors on the scene's device."""

    neighbors: torch.Tensor   # (F, 3)
    edge_id: torch.Tensor     # (F, 3)


def build_face_adjacency(scene, edges) -> FaceAdjacency:
    """Match each directed face edge against the unique edge table, on the
    host (the sorted-key construction of ``build_silhouette_edges``)."""
    f = scene.geometry()[1].cpu().numpy()
    F = f.shape[0]
    # directed edges in slot order (v0, v1), (v1, v2), (v2, v0)
    de = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=1)
    key = np.sort(de.reshape(-1, 2), axis=1).astype(np.int64)
    ev0 = edges.v0.cpu().numpy().astype(np.int64)
    ev1 = edges.v1.cpu().numpy().astype(np.int64)
    table_key = ev0 * (2 ** 31) + ev1
    probe = key[:, 0] * (2 ** 31) + key[:, 1]
    order = np.argsort(table_key)
    pos = np.searchsorted(table_key[order], probe)
    eid = order[np.clip(pos, 0, len(order) - 1)]
    if not (table_key[eid] == probe).all():
        raise ValueError("the edge table does not hold every face edge")
    f0 = edges.f0.cpu().numpy()[eid]
    f1 = edges.f1.cpu().numpy()[eid]
    nb = np.where(f0 == np.repeat(np.arange(F), 3), f1, f0)
    return FaceAdjacency(*(torch.as_tensor(a.reshape(F, 3), dtype=torch.int64,
                                           device=scene.device)
                           for a in (nb, eid)))


@dataclass
class SilhouetteSample:
    """A projection's result (SilhouetteSample3f, records.h)."""

    p: torch.Tensor       # (N, 3) the point on the silhouette edge
    d: torch.Tensor       # (N, 3) the direction viewpoint -> p
    edge: torch.Tensor    # (N,) EdgeTable row, -1 where not valid
    t: torch.Tensor       # (N,) the position along the table's v0 -> v1
    prim: torch.Tensor    # (N,) the face the sample lies on
    valid: torch.Tensor   # (N,) bool


def _unit(v):
    return v / sqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-20))


def _select(m, a, b):
    """The SilhouetteSample taking ``a`` on the lanes ``m``, ``b``
    elsewhere (valid: either's)."""
    return SilhouetteSample(
        p=torch.where(m[:, None], a.p, b.p),
        d=torch.where(m[:, None], a.d, b.d),
        edge=torch.where(m, a.edge, b.edge), t=torch.where(m, a.t, b.t),
        prim=torch.where(m, a.prim, b.prim), valid=b.valid | m)


def silhouette_projection(verts, faces, fn, adj: FaceAdjacency, viewpoint,
                          prim, u, active, heuristic: bool):
    """One projection step (mesh.cpp:1036) -> (sample, next face).  With
    ``heuristic`` the step also moves: the next face is the neighbour
    across the chosen edge; without it only a true silhouette edge gives
    a valid sample and the face stays."""
    fi = faces[prim]                                    # (N, 3)
    p = verts[fi]                                       # (N, 3, 3)
    nb = adj.neighbors[prim]                            # (N, 3)
    boundary = nb < 0
    n_self = fn[prim]                                   # (N, 3)
    n_oppo = fn[torch.clamp(nb, min=0)]                 # (N, 3, 3)

    # the viewing ray to one vertex of each edge: edge k uses vertex k + 1
    # (mesh.cpp:1073-1081)
    ray_d = _unit(p - viewpoint[:, None, :])
    rd_next = torch.stack([ray_d[:, 1], ray_d[:, 2], ray_d[:, 0]], dim=1)
    sgn_self = torch.sign(dot(rd_next, n_self[:, None, :]))
    cos_oppo = dot(rd_next, n_oppo) * sgn_self          # (N, 3)
    cos_oppo = torch.where(boundary, -1.0, cos_oppo)

    if heuristic:
        # the arccos weight, silhouette edges flat at pi / 2, a 1 degree
        # floor
        w = torch.arccos(torch.clamp(cos_oppo, -1.0, 1.0))
        w = torch.where(cos_oppo <= 0.0, math.pi / 2.0, w)
        w = torch.clamp(w, min=math.radians(1.0))
    else:
        w = (cos_oppo < 0.0).to(torch.float32)
        none_sil = dot(w, torch.ones_like(w)) == 0.0
        w = torch.where(none_sil[:, None], torch.ones_like(w), w)
    w = w / dot(w, torch.ones_like(w), keepdim=True)

    c0 = w[:, 0]
    c01 = w[:, 0] + w[:, 1]
    k = torch.where(u >= c0, 1, 0)
    k = torch.where(u >= c01, 2, k)
    cos_k = torch.gather(cos_oppo, 1, k[:, None])[:, 0]
    failed = cos_k > 0.0

    # reuse the sample inside the chosen bin (mesh.cpp:1143-1156)
    t_dir = torch.where(
        k == 0, u / torch.clamp(c0, min=1e-12),
        torch.where(k == 1, (u - c0) / torch.clamp(w[:, 1], min=1e-12),
                    (u - c01) / torch.clamp(w[:, 2], min=1e-12)))
    t_dir = torch.clamp(t_dir, 0.0, 1.0 - 1e-6)

    ia = torch.gather(fi, 1, k[:, None])[:, 0]
    ib = torch.gather(fi, 1, ((k + 1) % 3)[:, None])[:, 0]
    ss_p = verts[ia] * (1.0 - t_dir[:, None]) + verts[ib] * t_dir[:, None]
    eid = torch.gather(adj.edge_id[prim], 1, k[:, None])[:, 0]
    valid = active & ~failed
    ss = SilhouetteSample(
        p=ss_p, d=_unit(ss_p - viewpoint), edge=torch.where(valid, eid, -1),
        # the EdgeTable holds v0 < v1: flip t where the directed edge runs
        # the other way
        t=torch.where(ia < ib, t_dir, 1.0 - t_dir), prim=prim, valid=valid)
    if not heuristic:
        return ss, prim
    nb_k = torch.gather(nb, 1, k[:, None])[:, 0]
    return ss, torch.where(nb_k >= 0, nb_k, prim)


def mesh_walk(verts, faces, fn, adj: FaceAdjacency, viewpoint, prim, seed,
              lane, active, max_walk: int = 16):
    """The heuristic mesh walk (projective.py:600-634): step to the
    neighbour whose shared edge looks most silhouette-like, ``max_walk``
    times on every lane; the last step that lands on a true silhouette
    edge wins (deeper steps refine earlier hits)."""
    n = prim.shape[0]
    zero3 = torch.zeros((n, 3), device=verts.device)
    best = SilhouetteSample(
        p=zero3, d=zero3, edge=torch.full((n,), -1, device=verts.device),
        t=torch.zeros(n, device=verts.device), prim=prim,
        valid=torch.zeros(n, dtype=torch.bool, device=verts.device))
    cur = prim
    for i in range(max_walk):
        u = rng.sample_1d(seed, lane, DIM_PROJ + i)
        ss, cur = silhouette_projection(verts, faces, fn, adj, viewpoint,
                                        cur, u, active, heuristic=True)
        best = _select(ss.valid, ss, best)
    return best


def mesh_jump(scene, ctx, viewpoint, si, active, max_jump: int = 2):
    """Newton jumps toward the smooth-silhouette set dot(H, n_s(p)) = 0 of
    the shading-normal field (projective.py:637-693): solve the
    first-order normal model for the in-plane offset, re-intersect, and
    keep the landing face.  Returns (face, point, landed).  A faceted
    mesh's normal rows are its vertices (``Scene.geometry``), as in the
    JAX package."""
    verts, faces, norms = (x.detach() for x in scene.geometry()[:3])
    prim, p, act = si.prim_index, si.p.detach(), active
    for _ in range(max_jump):
        pv = verts[faces[prim]]                         # (N, 3, 3)
        nv = norms[faces[prim]]
        # the barycentric parameterisation dp/du = p1 - p0, dp/dv = p2 - p0
        dp_du = pv[:, 1] - pv[:, 0]
        dp_dv = pv[:, 2] - pv[:, 0]
        # the unnormalised shading normal is linear in the barycentrics
        dn_du = nv[:, 1] - nv[:, 0]
        dn_dv = nv[:, 2] - nv[:, 0]
        # the current point's barycentrics, solved in the triangle's plane
        d0 = p - pv[:, 0]
        e11, e12, e22 = dot(dp_du, dp_du), dot(dp_du, dp_dv), dot(dp_dv, dp_dv)
        q1, q2 = dot(d0, dp_du), dot(d0, dp_dv)
        det = torch.clamp(e11 * e22 - e12 * e12, min=1e-20)
        b1 = (e22 * q1 - e12 * q2) / det
        b2 = (e11 * q2 - e12 * q1) / det
        n_tilde = (nv[:, 0] * (1.0 - b1 - b2)[:, None] + nv[:, 1] * b1[:, None]
                   + nv[:, 2] * b2[:, None])
        inv_len = 1.0 / sqrt(torch.clamp(
            dot(n_tilde, n_tilde, keepdim=True), min=1e-20))
        n_hat = n_tilde * inv_len

        def dnorm(dn):
            # the normalised normal's derivative: (I - n n^T) dn~ / |n~|
            return (dn - n_hat * dot(n_hat, dn, keepdim=True)) * inv_len

        dn_du_n, dn_dv_n = dnorm(dn_du), dnorm(dn_dv)
        H = _unit(viewpoint - p)
        a, b, c = dot(H, dn_du_n), dot(H, dn_dv_n), dot(H, n_hat)
        ab2 = a * a + b * b
        ok = act & (ab2 > 1e-12)
        rcp = 1.0 / torch.clamp(ab2, min=1e-12)
        Q1, Q2 = -a * c * rcp, -b * c * rcp
        p_proj = p + Q1[:, None] * dp_du + Q2[:, None] * dp_dv
        n_proj = _unit(n_hat + Q1[:, None] * dn_du_n + Q2[:, None] * dn_dv_n)
        eps = 1e-4 * torch.clamp(p_proj.abs().amax(-1, keepdim=True), min=1.0)
        o = p_proj + n_proj * eps
        si2 = scene.ray_intersect(
            Ray(o=o, d=-n_proj, maxt=torch.full_like(o[:, 0], math.inf)), ok,
            ctx)
        landed = ok & si2.is_valid() & (si2.shape_index == si.shape_index)
        prim = torch.where(landed, si2.prim_index, prim)
        p = torch.where(landed[:, None], si2.p.detach(), p)
        act = landed
    return prim, p, act


@dataclass
class _SeedPoint:
    """What ``mesh_jump`` reads of a surface interaction."""

    prim_index: torch.Tensor
    p: torch.Tensor
    shape_index: torch.Tensor


def hybrid_projection(scene, ctx, edges, adj: FaceAdjacency, viewpoint, si,
                      seed, lane, active, max_walk: int = 30):
    """The walk, then a jump for the lanes it left stranded
    (projective.py:695-729 hybrid_mesh_projection): on a smooth mesh the
    walk drifts only weakly, so a failed walk is rescued by two Newton
    iterations from a uniform point of its last face, then a strict
    silhouette pick on the landing face."""
    from .projective import _face_normals

    verts, faces = scene.geometry()[:2]
    verts = verts.detach()
    fn = _face_normals(verts, faces)
    ss = mesh_walk(verts, faces, fn, adj, viewpoint, si.prim_index, seed,
                   lane, active, max_walk=max_walk)
    need_jump = active & ~ss.valid

    # the jump's seed: a uniform point of the walk's last face
    u2 = rng.sample_2d(seed, lane, DIM_PROJ + 128)
    st = sqrt(torch.clamp(u2[:, 0], min=0.0))
    b1 = 1.0 - st
    b2 = st * u2[:, 1]
    pv = verts[faces[ss.prim]]
    p_seed = (pv[:, 0] * (1.0 - b1 - b2)[:, None] + pv[:, 1] * b1[:, None]
              + pv[:, 2] * b2[:, None])
    # two Newton iterations: one from a face centroid still lands a couple
    # of faces from the contour, the second converges it
    prim_j, _, landed = mesh_jump(
        scene, ctx, viewpoint, _SeedPoint(ss.prim, p_seed, si.shape_index),
        need_jump, max_jump=2)
    u = rng.sample_1d(seed, lane, DIM_PROJ + 129)
    ss_j, _ = silhouette_projection(verts, faces, fn, adj, viewpoint, prim_j,
                                    u, landed, heuristic=False)
    return _select(need_jump & ss_j.valid, ss_j, ss)


def light_faces(scene, verts, faces):
    """The faces of the scene's first emitter's shape: (their vertex ids
    (L, 3), corners v0, v1, v2 (L, 3) each, areas (L,))."""
    counts = [int(m.faces.shape[0]) for m in scene.meshes]
    fshape = np.repeat(np.arange(len(counts)), counts)
    lfaces = np.nonzero(fshape == scene.emitter_shape[0])[0]
    lf = faces[torch.as_tensor(lfaces, device=faces.device)]
    lv0, lv1, lv2 = verts[lf[:, 0]], verts[lf[:, 1]], verts[lf[:, 2]]
    c = cross(lv1 - lv0, lv2 - lv0)
    return lf, lv0, lv1, lv2, 0.5 * sqrt(torch.clamp(dot(c, c),
                                                     min=1e-30))


def light_point(lv0, lv1, lv2, lidx, u_ly):
    """A uniform point y of light face ``lidx`` from u_ly (N, 2), its unit
    normal, and its barycentrics (b0, b1) of v1 and v2."""
    st = sqrt(torch.clamp(1.0 - u_ly[:, 0], min=0.0))
    b0 = 1.0 - st
    b1 = st * u_ly[:, 1]
    y = (lv0[lidx] * (1.0 - b0 - b1)[:, None] + lv1[lidx] * b0[:, None]
         + lv2[lidx] * b1[:, None])
    return y, _unit(cross(lv1[lidx] - lv0[lidx], lv2[lidx] - lv0[lidx])), \
        b0, b1


def project_seed_points(scene, edges, adj: FaceAdjacency, seed,
                        n_seeds: int, max_walk: int = 16):
    """Light-side seeds for the shadow term's octree
    (ProjectiveDetail.init_indirect_silhouette's projection modes,
    projective.py:228-373): a light point y, a cosine ray from it into the
    scene, and the hit face walked onto a silhouette edge as seen from y.
    Returns the (u_edge, t, u_light) cube points (N, 3) of
    ``_indirect_pass`` and their validity."""
    from .projective import DIM_B_SUB, _detached

    scene_det = _detached(scene)
    with torch.no_grad():
        ctx = scene_det.trace_ctx()
        verts, faces = scene_det.geometry()[:2]
        _, lv0, lv1, lv2, lareas = light_faces(scene_det, verts, faces)
        ldistr = UniformDistr.create(lareas)
        p0, p1 = verts[edges.v0], verts[edges.v1]
        edistr = UniformDistr.create(
            sqrt(torch.clamp(dot(p1 - p0, p1 - p0), min=1e-20)))

        lane = torch.arange(n_seeds, dtype=torch.int64, device=verts.device)
        seed_p = (int(seed) & rng.MASK32) ^ _SEED_SALT

        # the light point y, drawn as in _indirect_pass
        u_lf = rng.sample_1d(seed_p, lane, DIM_B_SUB)
        lidx, _ = ldistr.sample(u_lf)
        y, n_y, _, _ = light_point(lv0, lv1, lv2, lidx,
                                   rng.sample_2d(seed_p, lane, DIM_B_SUB + 1))
        # a cosine-weighted direction about n_y
        d = Frame.to_world(Frame.from_normal(n_y), square_to_cosine_hemisphere(
            rng.sample_2d(seed_p, lane, DIM_PROJ + 64)))
        si = scene_det.ray_intersect(
            Ray(o=y + d * 1e-4, d=d, maxt=torch.full_like(d[:, 0], math.inf)),
            torch.ones(n_seeds, dtype=torch.bool, device=verts.device), ctx)
        hit = si.is_valid() & (si.shape_index != scene_det.emitter_shape[0]) \
            & (si.shape_index < len(scene_det.meshes))
        ss = hybrid_projection(
            scene_det, ctx, edges, adj, y,
            dataclasses.replace(si, prim_index=torch.clamp(
                si.prim_index, 0, faces.shape[0] - 1)),
            seed_p, lane, hit, max_walk=max_walk)

        # edge and t -> u_edge through the length-weighted CDF (the inverse
        # of UniformDistr.sample: u = cdf[e - 1] + frac * pmf[e])
        dd = edistr.distr
        pmf_n = dd.pmf / torch.clamp(dd.total, min=1e-20)
        e = torch.clamp(ss.edge, min=0)
        lo = torch.where(e > 0, dd.cdf[torch.clamp(e - 1, min=0)], 0.0)
        u_frac = rng.sample_1d(seed_p, lane, DIM_PROJ + 65)
        u_edge = torch.clamp(lo + u_frac * pmf_n[e], 0.0, 1.0 - 1e-7)
        return torch.stack([u_edge, ss.t, u_lf], dim=-1), hit & ss.valid
