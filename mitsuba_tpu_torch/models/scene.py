"""Scene: geometry aggregation, ray queries, emitter sampling and BSDF
dispatch (mitsuba_tpu/models/scene.py; reference src/render/scene.cpp).

All shapes are triangle meshes, concatenated into one global
vertex/face buffer by ``geometry()``; static per-face shape ids map a hit
back to its shape and so to its BSDF and emitter.  A scene of more
faces than the brute kernels take (``MAX_FACES``) gets a host-built BVH
(ops/bvh.py) at ``make_scene``, as the JAX package's does
(scene.py:924-985, without its TPU-only packet accel).

The query and sampling half serves the wavefront ``PathIntegrator``:
``trace_ctx`` packs the geometry once a render; ``ray_intersect`` is a
detached hit query (``intersect_packed`` without a BVH,
``packet_closest_hit`` with one) followed by ``compute_si``; ``ray_test``
is the shadow query; BSDFs and emitters are dispatched by a masked sweep
over the scene's (few) instances; ``eval_env`` gives escaped rays the
environment map's radiance.  Only the mesh branches are ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import dataclasses

import numpy as np
import torch

from ..core.distr import DiscreteDistribution
from ..core.math import Frame, cross, normalize
from ..core.records import (DirectionSample, PreliminaryIntersection,
                            SurfaceInteraction, select)
from ..ops.bvh import BVH, build_bvh
from ..ops.intersect import ray_triangle
from ..ops.intersect_packed import intersect_packed, pack_triangles
from ..ops.megakernel import MAX_FACES
from ..ops.traverse import (pack_bvh_geometry, packet_any_hit,
                            packet_closest_hit)


@dataclass
class Scene:
    meshes: tuple          # tuple[Mesh, ...]
    bsdfs: tuple
    emitters: tuple
    sensor: object
    device: torch.device
    shape_bsdf: tuple = ()       # per-shape BSDF index
    shape_emitter: tuple = ()    # per-shape emitter index (-1: none)
    emitter_shape: tuple = ()    # per-emitter shape index (-1: none)
    accel: BVH | None = None     # over geometry(); None at <= MAX_FACES
    scene_center: tuple = (0.0, 0.0, 0.0)   # bounding sphere of the
    scene_radius: float = 1.0                # vertices (scene.py:867-884)
    face_distrs: tuple = ()      # per-emitter face-area distribution
    emitter_distr: DiscreteDistribution | None = None   # emitter selection
    env_index: int = -1          # the infinite emitter's index (-1: none)

    # ---------------------------------------------------------- geometry

    def geometry(self):
        """Concatenated (vertices, faces, normals, uvs, face_shape,
        face_smooth), face indices rebased.  Flat meshes contribute their
        vertices as placeholder normal rows, as in the JAX package."""
        vs, fs, ns, uvs, fshape, fsmooth = [], [], [], [], [], []
        off = 0
        for i, m in enumerate(self.meshes):
            nv, nf = m.vertices.shape[0], m.faces.shape[0]
            vs.append(m.vertices)
            fs.append(m.faces + off)
            ns.append(m.normals if m.normals is not None else m.vertices)
            uvs.append(m.uvs if m.uvs is not None
                       else torch.zeros((nv, 2), device=self.device))
            fshape.append(torch.full((nf,), i, device=self.device))
            fsmooth.append(torch.full((nf,), m.normals is not None,
                                      device=self.device))
            off += nv
        return (torch.cat(vs), torch.cat(fs), torch.cat(ns), torch.cat(uvs),
                torch.cat(fshape), torch.cat(fsmooth))

    # ------------------------------------------------------- trace context

    def trace_ctx(self):
        """The geometry the queries read, packed once a render
        (scene.py:106-171): ``tri_data`` (F, 26) = p0 p1 p2 | n0 n1 n2 |
        uv0 uv1 uv2 | shape_id smooth, the per-face shape ids, and
        ``pack_triangles``' table without a BVH or the walk's tables with
        one."""
        v, f, n, uv, fshape, fsmooth = self.geometry()
        F = int(f.shape[0])
        p = v[f]                                     # (F, 3, 3)
        tri_data = torch.cat([p.reshape(F, 9), n[f].reshape(F, 9),
                              uv[f].reshape(F, 6),
                              fshape.to(torch.float32)[:, None],
                              fsmooth.to(torch.float32)[:, None]], dim=-1)
        ctx = {"tri_data": tri_data, "fshape": fshape}
        if self.accel is None:
            ctx["tris_packed"] = pack_triangles(v, f)
        else:
            geo = torch.cat([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1)
            ctx["bvh"] = pack_bvh_geometry(self.accel, geo)
        return ctx

    # -------------------------------------------------------- ray queries

    def ray_intersect_preliminary(self, ray, active, ctx):
        """Closest-hit query -> PreliminaryIntersection (shape.h:222).
        The BVH query gives no barycentrics (prim_uv = 0, as the TPU
        packet kernel); ``compute_si`` re-derives them."""
        n = ray.o.shape[0]
        if "bvh" in ctx:
            t, prim = packet_closest_hit(ctx["bvh"], ray.o, ray.d, ray.maxt,
                                         active)
            prim_uv = torch.zeros((n, 2), device=ray.o.device)
        else:
            t, prim, u, v = intersect_packed(ctx["tris_packed"], ray.o, ray.d,
                                             ray.maxt, active)
            prim_uv = torch.stack([u, v], dim=-1)
        prim = torch.clamp(prim.long(), min=0)
        valid = torch.isfinite(t)
        return PreliminaryIntersection(
            t=t, prim_index=prim, prim_uv=prim_uv,
            shape_index=torch.where(valid, ctx["fshape"][prim], -1))

    def compute_si(self, pi, ray, ctx):
        """SurfaceInteraction from a preliminary intersection
        (scene.py:278-351, the JAX package's ``"attach"`` mode; the other
        modes wait for the differentiable slice): (t, u, v) re-derived on
        the hit face by ``ray_triangle``, the traversal's where that
        degenerates."""
        valid = pi.is_valid()
        prim = torch.where(valid, pi.prim_index, 0)
        td = ctx["tri_data"][prim]
        p0, p1, p2 = td[:, 0:3], td[:, 3:6], td[:, 6:9]
        n0, n1, n2 = td[:, 9:12], td[:, 12:15], td[:, 15:18]
        uv0, uv1, uv2 = td[:, 18:20], td[:, 20:22], td[:, 22:24]
        smooth = td[:, 25] > 0.5
        t, u, v, _ = ray_triangle(ray.o, ray.d, p0, p1, p2)
        ok = torch.isfinite(t)
        t = torch.where(ok, t, pi.t)
        u = torch.clamp(torch.where(ok, u, pi.prim_uv[..., 0]), 0.0, 1.0)
        v = torch.clamp(torch.where(ok, v, pi.prim_uv[..., 1]), 0.0, 1.0)
        b0 = 1.0 - u - v
        p = p0 * b0[:, None] + p1 * u[:, None] + p2 * v[:, None]
        ng = normalize(cross(p1 - p0, p2 - p0))
        ns = normalize(n0 * b0[:, None] + n1 * u[:, None] + n2 * v[:, None])
        sh_n = torch.where(smooth[:, None], ns, ng)
        uv = uv0 * b0[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
        s, tt, _ = Frame.from_normal(sh_n)
        return SurfaceInteraction(
            t=torch.where(valid, t, float("inf")), p=p, n=ng, sh_n=sh_n,
            sh_s=s, sh_t=tt, uv=uv, wi=Frame.to_local((s, tt, sh_n), -ray.d),
            shape_index=torch.where(valid, pi.shape_index, -1),
            prim_index=prim)

    def ray_intersect(self, ray, active, ctx):
        """Closest-hit query + SI recomputation (scene.cpp:181)."""
        return self.compute_si(
            self.ray_intersect_preliminary(ray, active, ctx), ray, ctx)

    def ray_test(self, ray, active, ctx):
        """Any-hit (shadow) query for the lanes in ``active``
        (scene.cpp:203)."""
        if "bvh" in ctx:
            return packet_any_hit(ctx["bvh"], ray.o, ray.d, ray.maxt, active)
        t, _, _, _ = intersect_packed(ctx["tris_packed"], ray.o, ray.d,
                                      ray.maxt, active)
        return torch.isfinite(t)

    # ------------------------------------------------------ BSDF dispatch

    def _per_shape(self, values, shape_index):
        """``values[shape]`` for each lane's shape, -1 on a miss."""
        table = torch.tensor(values, dtype=torch.int64, device=self.device)
        return torch.where(shape_index >= 0,
                           table[torch.clamp(shape_index, min=0)], -1)

    def lane_bsdf_index(self, si):
        return self._per_shape(self.shape_bsdf, si.shape_index)

    def bsdf_sample(self, si, sample1, sample2, active):
        """Masked sweep over the scene's BSDFs (scene.cpp:320)."""
        bidx = self.lane_bsdf_index(si)
        out_bs = out_w = None
        for i, b in enumerate(self.bsdfs):
            m = active & (bidx == i)
            bs, w = b.sample(si, sample1, sample2, m)
            if out_bs is None:
                out_bs, out_w = bs, w
            else:
                out_bs = select(m, bs, out_bs)
                out_w = torch.where(m[:, None], w, out_w)
        # lanes that no mask took: zero pdf and weight
        out_w = torch.where(active[:, None], out_w, 0.0)
        out_bs.pdf = torch.where(active, out_bs.pdf, 0.0)
        return out_bs, out_w

    def bsdf_eval_pdf(self, si, wo, active):
        """Fused eval + pdf sweep (bsdf.h:415)."""
        bidx = self.lane_bsdf_index(si)
        val = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
        pdf = torch.zeros(wo.shape[:-1], device=wo.device)
        for i, b in enumerate(self.bsdfs):
            m = active & (bidx == i)
            v, p = b.eval_pdf(si, wo, m)
            val = torch.where(m[:, None], v, val)
            pdf = torch.where(m, p, pdf)
        return val, pdf

    # --------------------------------------------------- emitter sampling

    def _emitter_geom(self, ei: int):
        s = self.emitter_shape[ei]
        return None if s < 0 else (self.meshes[s], self.face_distrs[ei])

    def sample_emitter_direction(self, si, sample1, sample2, active, ctx):
        """NEE (scene.cpp:299): pick an emitter, sample a direction toward
        it and trace the shadow ray.  Returns (DirectionSample, weight =
        Le / pdf, ok)."""
        idx, u_re, sel_pmf = self.emitter_distr.sample_reuse_pmf(sample1)
        ds = weight = None
        for i, e in enumerate(self.emitters):
            m = active & (idx == i)
            ds_i, w_i = e.sample_direction(si.p, u_re, sample2,
                                           self._emitter_geom(i))
            ds_i.emitter_index = torch.full_like(ds_i.emitter_index, i)
            if ds is None:
                ds, weight = ds_i, w_i
            else:
                ds = select(m, ds_i, ds)
                weight = torch.where(m[:, None], w_i, weight)
        # fold the emitter-selection pmf into pdf and weight
        ds.pdf = ds.pdf * sel_pmf
        weight = weight / torch.clamp(sel_pmf, min=1e-20)[:, None]
        ok = active & (ds.pdf > 0.0)
        ok = ok & ~self.ray_test(si.spawn_ray_to(ds.p), ok, ctx)
        weight = torch.where(ok[:, None], weight, 0.0)
        ds.pdf = torch.where(active, ds.pdf, 0.0)
        return ds, weight, ok

    # --------------------------------------------------- emitter evaluation

    def eval_emitter_hit(self, si, ref_p, active):
        """Radiance and NEE pdf (selection pmf included) for a
        BSDF-sampled ray that hit an emitter (path.cpp:158-174)."""
        eidx = self._per_shape(self.shape_emitter, si.shape_index)
        le = torch.zeros(si.p.shape[:-1] + (3,), device=si.p.device)
        pdf = torch.zeros(si.p.shape[:-1], device=si.p.device)
        delta = si.p - ref_p
        zero = torch.zeros_like(si.t)
        ds = DirectionSample(
            p=si.p, n=si.n, uv=si.uv, d=normalize(delta),
            dist=torch.sqrt(torch.clamp(torch.sum(delta ** 2, dim=-1),
                                        min=1e-20)),
            pdf=zero, delta=zero.bool(), emitter_index=torch.clamp(eidx, min=0))
        for i, e in enumerate(self.emitters):
            if getattr(e, "is_infinite", False):
                continue
            m = active & (eidx == i)
            le = torch.where(m[:, None], e.eval(si, m), le)
            p = e.pdf_direction(ref_p, ds, self._emitter_geom(i))
            pdf = torch.where(m, p * self.emitter_distr.eval_pmf_normalized(i),
                              pdf)
        return le, pdf

    def eval_env(self, ray, ref_p, active):
        """Radiance and NEE pdf (selection pmf included) of the environment
        map for escaped rays (scene.py:778 of the JAX package); zeros
        without one."""
        n = ray.d.shape[0]
        le = torch.zeros((n, 3), device=ray.d.device)
        pdf = torch.zeros(n, device=ray.d.device)
        if self.env_index < 0:
            return le, pdf
        e = self.emitters[self.env_index]
        le = torch.where(active[:, None], e.eval_env(ray.d, active), le)
        zero = torch.zeros(n, device=ray.d.device)
        r = 2.0 * self.scene_radius
        ds = DirectionSample(
            p=ref_p + ray.d * r, n=-ray.d, uv=torch.zeros((n, 2),
                                                         device=ray.d.device),
            d=ray.d, dist=zero + r, pdf=zero, delta=zero.bool(),
            emitter_index=torch.full((n,), self.env_index,
                                     device=ray.d.device))
        p = e.pdf_direction(ref_p, ds)
        sel = self.emitter_distr.eval_pmf_normalized(self.env_index)
        return le, torch.where(active, p * sel, 0.0)

    @property
    def environment(self):
        return self.emitters[self.env_index] if self.env_index >= 0 else None


# ------------------------------------------------------------------ build

def make_scene(meshes, bsdfs, emitters, sensor, device):
    """Assemble a Scene from meshes wired to their plugins by each mesh's
    ``bsdf_index`` / ``emitter_index`` (reference Scene ctor,
    scene.cpp:22-96).  Every tensor must already live on ``device``.
    Builds each area light's face-area distribution and the emitter
    selection distribution from the sampling weights (scene.cpp:100-115);
    above ``MAX_FACES`` faces in all, the BVH, on the host.  An infinite
    emitter (the environment map) gets the scene's bounding sphere, its
    radius times 1.01, and the last one is ``env_index``."""
    meshes, bsdfs, emitters = tuple(meshes), tuple(bsdfs), tuple(emitters)
    device = torch.device(device)
    emitter_shape = tuple(
        next((s for s, m in enumerate(meshes) if m.emitter_index == e), -1)
        for e in range(len(emitters)))
    # scene bounding sphere, in float32 as the JAX package computes it
    all_v = np.concatenate([m.vertices.cpu().numpy() for m in meshes])
    center = all_v.mean(axis=0)
    radius = max(float(np.max(np.linalg.norm(all_v - center, axis=1))), 1e-3)
    env_index = -1
    ems = []
    for i, e in enumerate(emitters):
        if getattr(e, "is_infinite", False):
            env_index = i
            e = dataclasses.replace(
                e, scene_center=tuple(float(c) for c in center),
                scene_radius=float(np.float32(radius * 1.01)))
        ems.append(e)
    emitters = tuple(ems)
    weights = [float(e.sampling_weight) for e in emitters] or [1.0]
    scene = Scene(
        meshes=meshes, bsdfs=bsdfs, emitters=emitters, sensor=sensor,
        device=device,
        shape_bsdf=tuple(int(m.bsdf_index) for m in meshes),
        shape_emitter=tuple(int(m.emitter_index) for m in meshes),
        emitter_shape=emitter_shape,
        scene_center=tuple(float(c) for c in center),
        scene_radius=radius,
        face_distrs=tuple(
            DiscreteDistribution.create(meshes[s].face_areas()) if s >= 0
            else None for s in emitter_shape),
        emitter_distr=DiscreteDistribution.create(
            torch.tensor(weights, device=device)),
        env_index=env_index,
    )
    if sum(int(m.faces.shape[0]) for m in meshes) > MAX_FACES:
        v, f = scene.geometry()[:2]
        scene.accel = build_bvh(v.cpu().numpy(), f.cpu().numpy(),
                                device=device)
    return scene
