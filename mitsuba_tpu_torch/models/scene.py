"""Scene: geometry aggregation, ray queries, emitter sampling and BSDF
dispatch (mitsuba_tpu/models/scene.py; reference src/render/scene.cpp).

All shapes are triangle meshes, concatenated into one global
vertex/face buffer by ``geometry()``; static per-face shape ids map a hit
back to its shape and so to its BSDF and emitter.  A scene of more
faces than the brute kernels take (``MAX_FACES``) gets a host-built BVH
(ops/bvh.py) at ``make_scene``, as the JAX package's does
(scene.py:924-985, without its TPU-only packet accel).

The query and sampling half serves the wavefront ``PathIntegrator`` and
the PRB integrators: ``trace_ctx`` packs the detached geometry once a
render; ``ray_intersect`` is a detached hit query (``intersect_packed``
without a BVH, ``packet_closest_hit`` with one) followed by
``compute_si``, which PRB re-runs on the attached ``shading_ctx``;
``ray_test`` is the shadow query; ``sample_emitter_ray`` emits the
particle tracer's particles; BSDFs and emitters are dispatched by
a masked sweep over the scene's (few) instances; ``eval_env`` gives
escaped rays the environment map's radiance; ``eval_emitter_direction``
re-evaluates an NEE sample's radiance attached.

The shape slots are the JAX package's: the meshes, then one slot for
the scene's SDF grid (``models/sdf.py``), then the exact analytic prims
(``models/analytic.py``; spheres, disks, cylinders and curves) from
``_analytic_base``, then one slot per (group, submesh) of the
instanced groups (``models/instancing.py``) from ``_instance_base``.
Each joins the preliminary hit by closest t, in that order after the
mesh query (the SDF's trace too, so the PRB walks, which call
``ray_intersect_preliminary`` and ``compute_si``, see it, where the JAX
package merges it in ``ray_intersect`` alone); ``compute_si`` rebuilds
each kind's lanes by its own interaction, and ``ray_test`` ORs each
kind's any-hit into the shadow query.  An emitting analytic sphere
lights the scene through ``SphereGeom``; NEE from a point on that
sphere toward it gives 0 (a convex emitter does not light itself).

Every per-lane gather of an attached table (the faces' corners, a hit
face's row) goes through ``ops/gather.py::gather_rows``, whose backward
adds in a fixed order, so PRB's adjoint repeats bit for bit on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import dataclasses

import numpy as np
import torch

from ..core.distr import DiscreteDistribution
from ..core.math import Frame, cross, dot, normalize, sqrt
from ..core.records import (DirectionSample, PreliminaryIntersection,
                            SurfaceInteraction, select)
from ..device import resolve_device
from .analytic import AnalyticShapes
from .instancing import (group_any, group_closest, group_shading_ctx,
                         group_trace_ctx, instanced_si)
from .sdf import SDFGrid
from ..ops.bvh import BVH, build_bvh, refit_bvh
from ..ops.gather import gather_rows
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
    scene_analytic: AnalyticShapes | None = None   # slots after the SDF
    scene_sdf: SDFGrid | None = None   # the slot after the meshes
    instances: tuple = ()        # InstancedGroup's, slots after analytic
    integrator: object = None    # the scene's own (a loaded scene's), or None

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

    def shading_ctx(self):
        """The attached geometry ``compute_si`` reads (scene.py:106-171),
        without the queries' tables: ``tri_data`` (F, 26) = p0 p1 p2 | n0
        n1 n2 | uv0 uv1 uv2 | shape_id smooth, and the per-face shape
        ids.  Gradients reach the meshes' vertices, normals and uvs
        through it."""
        v, f, n, uv, fshape, fsmooth = self.geometry()
        F = int(f.shape[0])
        idx = f.reshape(-1).long()

        def corners(x):
            return gather_rows(x, idx).reshape(F, -1)

        tri_data = torch.cat([corners(v), corners(n), corners(uv),
                              fshape.to(torch.float32)[:, None],
                              fsmooth.to(torch.float32)[:, None]], dim=-1)
        ctx = {"tri_data": tri_data, "fshape": fshape}
        if self.instances:
            ctx["inst"] = [group_shading_ctx(g) for g in self.instances]
        return ctx

    def trace_ctx(self):
        """The geometry the queries read, packed once a render:
        ``shading_ctx`` plus ``pack_triangles``' table without a BVH or
        the walk's tables with one (and each instanced group's,
        ``group_trace_ctx``), all packed from detached vertices,
        so no kernel sees a tensor that requires grad.  The BVH's boxes
        are refitted to the current vertices (``refit_bvh``), as the JAX
        package does on every render (scene.py:155-170): moved vertices
        keep the tree's topology, and ``utils/params.py::refresh_accel``
        rebuilds it where the topology changes."""
        ctx = self.shading_ctx()
        if self.instances:
            ctx["inst"] = [group_trace_ctx(g, c)
                           for g, c in zip(self.instances, ctx["inst"])]
        v, f = self.geometry()[:2]
        v = v.detach()
        if self.accel is None:
            ctx["tris_packed"] = pack_triangles(v, f)
        else:
            p = v[f]
            geo = torch.cat([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1)
            ctx["bvh"] = pack_bvh_geometry(refit_bvh(self.accel, v), geo)
        return ctx

    # -------------------------------------------------------- ray queries

    def ray_intersect_preliminary(self, ray, active, ctx):
        """Closest-hit query of the detached ray -> PreliminaryIntersection
        (shape.h:222).  The BVH query gives no barycentrics (prim_uv = 0,
        as the TPU packet kernel); ``compute_si`` re-derives them."""
        n = ray.o.shape[0]
        o, d, maxt = ray.o.detach(), ray.d.detach(), ray.maxt.detach()
        if "bvh" in ctx:
            t, prim = packet_closest_hit(ctx["bvh"], o, d, maxt, active)
            prim_uv = torch.zeros((n, 2), device=ray.o.device)
        else:
            t, prim, u, v = intersect_packed(ctx["tris_packed"], o, d, maxt,
                                             active)
            prim_uv = torch.stack([u, v], dim=-1)
        prim = torch.clamp(prim.long(), min=0)
        valid = torch.isfinite(t)
        shape = torch.where(valid, ctx["fshape"][prim], -1)
        if self.scene_analytic is not None:
            # analytic prims are preliminary hits like faces: slots from
            # _analytic_base, prim_index the analytic prim (scene.py:223-241)
            t_a, prim_a = self.scene_analytic.intersect(o, d, maxt, active)
            closer = torch.isfinite(t_a) & (t_a < t)
            t = torch.where(closer, t_a, t)
            prim = torch.where(closer, prim_a, prim)
            prim_uv = torch.where(closer[:, None], 0.0, prim_uv)
            shape = torch.where(closer, self._analytic_base() + prim_a, shape)
        if self.scene_sdf is not None:
            # the SDF's slot, prim 0: compute_si attaches it
            t_s, hit = self.scene_sdf.ray_intersect(o, d, maxt, active)
            closer = hit & (t_s < t)
            t = torch.where(closer, t_s, t)
            prim = torch.where(closer, 0, prim)
            prim_uv = torch.where(closer[:, None], 0.0, prim_uv)
            shape = torch.where(closer, len(self.meshes), shape)
        inst = None
        if self.instances:
            # two-level instanced geometry (scene.py:242-270): one slot a
            # (group, submesh), the instance in inst_index
            inst = torch.full((n,), -1, dtype=torch.int64, device=o.device)
            slot0 = self._instance_base()
            for g, ctx_g in zip(self.instances, ctx["inst"]):
                t_g, prim_g, i_g = group_closest(g, ctx_g, o, d,
                                                 torch.minimum(t, maxt),
                                                 active)
                closer = torch.isfinite(t_g) & (t_g < t)
                t = torch.where(closer, t_g, t)
                prim = torch.where(closer, prim_g, prim)
                sub = g.fshape_g[torch.clamp(prim_g, min=0)]
                shape = torch.where(closer, slot0 + sub, shape)
                inst = torch.where(closer, i_g, inst)
                slot0 += g.n_submeshes
            prim_uv = torch.where((inst >= 0)[:, None], 0.0, prim_uv)
        return PreliminaryIntersection(t=t, prim_index=prim, prim_uv=prim_uv,
                                       shape_index=shape, inst_index=inst)

    def compute_si(self, pi, ray, ctx=None, mode: str = "attach"):
        """SurfaceInteraction from a preliminary intersection
        (scene.py:278-351): (t, u, v) re-derived on the hit face by
        ``ray_triangle``, the traversal's where that degenerates.
        ``ctx`` defaults to the attached ``shading_ctx``.  ``mode`` is the
        reference's RayFlags differentiability (interaction.h:19-68):

        - ``"attach"``: (t, u, v) follow the attached ray and vertices,
          so si.p slides along the ray to stay on a moving surface;
        - ``"follow_shape"``: the barycentrics are detached and t is
          recomputed from the attached p, so si.p moves with the shape;
        - ``"detach_shape"``: the face's data is detached, so no
          gradient reaches the shape; si.p still tracks the ray.

        The interaction carries the ray's hero wavelengths (None on an
        RGB path), which a dispersive BSDF reads.  Lanes that hit an
        analytic prim are rebuilt by ``AnalyticShapes.compute_si`` in the
        same mode (scene.py:300-360), lanes on the SDF by
        ``SDFGrid.attach_point`` and the grid's normal (scene.py:396-430;
        ``detach_shape`` detaches the grid) and lanes on an instance by
        ``instanced_si``.  The interaction's time waits for ROADMAP.md
        Queue 1 item 7.
        """
        if mode not in ("attach", "follow_shape", "detach_shape"):
            raise ValueError(f"unknown compute_si mode {mode!r}")
        if ctx is None:
            ctx = self.shading_ctx()
        hit = pi.is_valid()
        # the mesh lanes; the others leave the mesh gather
        valid = hit & (pi.shape_index < len(self.meshes))
        prim = torch.where(valid, pi.prim_index, 0)
        td = gather_rows(ctx["tri_data"], prim)
        if mode == "detach_shape":
            td = td.detach()
        p0, p1, p2 = td[:, 0:3], td[:, 3:6], td[:, 6:9]
        n0, n1, n2 = td[:, 9:12], td[:, 12:15], td[:, 15:18]
        uv0, uv1, uv2 = td[:, 18:20], td[:, 20:22], td[:, 22:24]
        smooth = td[:, 25] > 0.5
        t, u, v, _ = ray_triangle(ray.o, ray.d, p0, p1, p2)
        ok = torch.isfinite(t)
        t = torch.where(ok, t, pi.t)
        u = torch.clamp(torch.where(ok, u, pi.prim_uv[..., 0]), 0.0, 1.0)
        v = torch.clamp(torch.where(ok, v, pi.prim_uv[..., 1]), 0.0, 1.0)
        if mode == "follow_shape":
            u, v = u.detach(), v.detach()
        b0 = 1.0 - u - v
        p = p0 * b0[:, None] + p1 * u[:, None] + p2 * v[:, None]
        if mode == "follow_shape":
            t = sqrt(torch.clamp(dot(p - ray.o, p - ray.o), min=1e-30)
                     / torch.clamp(dot(ray.d, ray.d), min=1e-30))
        ng = normalize(cross(p1 - p0, p2 - p0))
        ns = normalize(n0 * b0[:, None] + n1 * u[:, None] + n2 * v[:, None])
        sh_n = torch.where(smooth[:, None], ns, ng)
        uv = uv0 * b0[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
        s, tt, _ = Frame.from_normal(sh_n)
        si = SurfaceInteraction(
            t=torch.where(valid, t, float("inf")), p=p, n=ng, sh_n=sh_n,
            sh_s=s, sh_t=tt, uv=uv, wi=Frame.to_local((s, tt, sh_n), -ray.d),
            shape_index=torch.where(valid, pi.shape_index, -1),
            prim_index=prim, wavelengths=ray.wavelengths)
        if self.scene_sdf is not None:
            si = self._sdf_si(si, pi, ray, hit & (pi.shape_index
                                                  == len(self.meshes)), mode)
        if self.scene_analytic is not None:
            is_analytic = hit & (pi.shape_index >= self._analytic_base()) \
                & (pi.shape_index < self._instance_base())
            si = select(is_analytic, self.scene_analytic.compute_si(
                ray, pi.t, pi.prim_index, is_analytic, mode=mode,
                shape_slot_base=self._analytic_base()), si)
        if self.instances:
            si = instanced_si(self, pi, ray, ctx, mode, si)
        return si

    def _sdf_si(self, si, pi, ray, on_sdf, mode):
        """``si`` with the SDF's lanes rebuilt (scene.py:396-430): the point
        ``attach_point`` of the detached hit, the normal of the grid's
        gradient at the detached hit (a function of the grid's values, as
        the JAX package's), t along the attached ray, uv 0."""
        idx = torch.nonzero(on_sdf).squeeze(1)
        if not idx.numel():
            return si
        sdf = self.scene_sdf
        if mode == "detach_shape":
            sdf = dataclasses.replace(sdf, values=sdf.values.detach())
        o, d = ray.o[idx], ray.d[idx]
        x_det = o.detach() + d.detach() * pi.t[idx][:, None]
        p = sdf.attach_point(x_det, d.detach())
        n = normalize(sdf.grad(x_det))
        s, tt, _ = Frame.from_normal(n)
        fields = {"t": dot(p - o, d), "p": p, "n": n, "sh_n": n, "sh_s": s,
                  "sh_t": tt, "uv": torch.zeros((idx.shape[0], 2),
                                                device=p.device),
                  "wi": Frame.to_local((s, tt, n), -d),
                  "shape_index": pi.shape_index[idx],
                  "prim_index": torch.zeros_like(idx)}
        return dataclasses.replace(si, **{
            k: getattr(si, k).index_copy(0, idx, v)
            for k, v in fields.items()})

    def ray_intersect(self, ray, active, ctx):
        """Closest-hit query + SI recomputation (scene.cpp:181)."""
        return self.compute_si(
            self.ray_intersect_preliminary(ray, active, ctx), ray, ctx)

    def ray_test(self, ray, active, ctx):
        """Any-hit (shadow) query for the lanes in ``active``
        (scene.cpp:203), on the detached ray."""
        o, d, maxt = ray.o.detach(), ray.d.detach(), ray.maxt.detach()
        if "bvh" in ctx:
            hit = packet_any_hit(ctx["bvh"], o, d, maxt, active)
        else:
            hit = torch.isfinite(intersect_packed(ctx["tris_packed"], o, d,
                                                  maxt, active)[0])
        if self.scene_sdf is not None:
            hit = hit | self.scene_sdf.ray_intersect(o, d, maxt, active)[1]
        if self.scene_analytic is not None:
            hit = hit | self.scene_analytic.any_hit(o, d, maxt, active)
        for g, ctx_g in zip(self.instances, ctx.get("inst", ())):
            hit = hit | group_any(g, ctx_g, o, d, maxt, active & ~hit)
        return hit

    def _analytic_base(self) -> int:
        """The first shape slot of the analytic prims: after the meshes
        and the SDF's slot."""
        return len(self.meshes) + (self.scene_sdf is not None)

    def _instance_base(self) -> int:
        """The first shape slot of the instanced groups' submeshes, after
        the analytic prims."""
        n = (self.scene_analytic.n_prims if self.scene_analytic is not None
             else 0)
        return self._analytic_base() + n

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
        if s < 0:
            return None
        if s >= self._analytic_base():
            # an emitting analytic sphere: exact cone sampling
            return (self.scene_analytic.sphere_geom(s - self._analytic_base()),
                    None)
        return (self.meshes[s], self.face_distrs[ei])

    def sample_emitter_direction(self, si, sample1, sample2, active, ctx):
        """NEE (scene.cpp:299): pick an emitter, sample a direction toward
        it and trace the shadow ray.  Returns (DirectionSample, weight =
        Le / pdf, ok).  A lane whose shading point lies on the analytic
        sphere it drew gets ok False and weight 0: a convex emitter does
        not light itself, and its degenerate cone would put the PRB
        re-evaluation's 1 / chord into the gradient (ROADMAP.md Queue 3,
        the self-lit NEE lanes).  Mesh lights are left as they are."""
        idx, u_re, sel_pmf = self.emitter_distr.sample_reuse_pmf(sample1)
        ds = weight = None
        self_lit = torch.zeros_like(active)
        for i, e in enumerate(self.emitters):
            m = active & (idx == i)
            if self.emitter_shape[i] >= self._analytic_base():
                self_lit = self_lit | (m & (si.shape_index
                                            == self.emitter_shape[i]))
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
        ok = active & (ds.pdf > 0.0) & ~self_lit
        ok = ok & ~self.ray_test(si.spawn_ray_to(ds.p), ok, ctx)
        weight = torch.where(ok[:, None], weight, 0.0)
        ds.pdf = torch.where(active, ds.pdf, 0.0)
        return ds, weight, ok

    def sample_emitter_ray(self, wavelength_sample, direction_sample,
                           position_sample, active):
        """A particle from an emitter picked by the selection distribution
        (Scene::sample_emitter_ray; ptracer.cpp prepare_ray), the
        wavelength sample reused for the pick as in the JAX package
        (scene.py:714).  Returns (ray, weight = Le-related / (pdf * pmf),
        PositionSample, emitter index per lane)."""
        idx, u_re, sel_pmf = self.emitter_distr.sample_reuse_pmf(
            wavelength_sample)
        ray = weight = ps = None
        for i, e in enumerate(self.emitters):
            m = active & (idx == i)
            r_i, w_i, ps_i = e.sample_ray(u_re, direction_sample,
                                          position_sample,
                                          self._emitter_geom(i))
            if ray is None:
                ray, weight, ps = r_i, w_i, ps_i
            else:
                ray, ps = select(m, r_i, ray), select(m, ps_i, ps)
                weight = torch.where(m[:, None], w_i, weight)
        weight = weight / torch.clamp(sel_pmf, min=1e-20)[:, None]
        return ray, torch.where(active[:, None], weight, 0.0), ps, idx

    def eval_emitter_direction(self, si, ds, active):
        """Attached radiance along a detached NEE sample
        (Scene::eval_emitter_direction, scene.py:689-699): PRB re-evaluates
        the emitter differentiably while the sample and its pdf stay
        detached."""
        le = torch.zeros(ds.d.shape[:-1] + (3,), device=ds.d.device)
        for i, e in enumerate(self.emitters):
            m = active & (ds.emitter_index == i)
            v = e.eval_direction(si.p, ds, self._emitter_geom(i), m)
            le = torch.where(m[:, None], v, le)
        return le

    def pdf_emitter_direction(self, ref_p, ds, active):
        """Solid-angle pdf of NEE having produced ``ds``, the selection
        pmf included (scene.cpp:355, scene.py:701-712)."""
        pdf = torch.zeros(ds.pdf.shape, device=ds.pdf.device)
        for i, e in enumerate(self.emitters):
            m = active & (ds.emitter_index == i)
            pdf = torch.where(m, e.pdf_direction(ref_p, ds,
                                                 self._emitter_geom(i)), pdf)
        sel = self.emitter_distr.eval_pmf_normalized(
            torch.clamp(ds.emitter_index, 0, max(len(self.emitters) - 1, 0)))
        return pdf * sel

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
            dist=sqrt(torch.clamp(dot(delta, delta),
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

def make_scene(meshes, bsdfs, emitters, sensor, device, analytic=None,
               sdf=None, instances=None, integrator=None):
    """Assemble a Scene from meshes wired to their plugins by each mesh's
    ``bsdf_index`` / ``emitter_index`` (reference Scene ctor,
    scene.cpp:22-96).  Every tensor must already live on ``device`` ("cuda"
    is the current card).
    Builds each area light's face-area distribution and the emitter
    selection distribution from the sampling weights (scene.cpp:100-115);
    above ``MAX_FACES`` faces in all, the BVH, on the host.  An infinite
    emitter (the environment map, the constant and the directional
    lights) gets the scene's bounding sphere, its radius times 1.01, and
    the last one is ``env_index``.  ``integrator`` is the scene's own,
    which ``render`` takes when given none (a loaded scene's).

    ``analytic``: an ``AnalyticShapes`` (``models/analytic.py``
    ``build_analytic``) whose prims take the shape slots after the
    meshes, each wired by its ``bsdf_index`` / ``emitter_index``; an
    emitter no mesh carries goes to the first prim that names it (a
    sphere: only spheres carry lights), and
    the prims' bounds join the bounding sphere (scene.py:809-900).

    ``sdf``: an ``SDFGrid`` (``models/sdf.py``), the slot after the meshes
    (the analytic prims then follow it), its box joining the bounding
    sphere.  ``instances``: ``InstancedGroup`` s (``models/instancing.py``),
    one slot a (group, submesh) after the analytic prims, their world
    boxes joining the bounding sphere; a submesh that carries an emitter
    raises, as the reference's instance.cpp does."""
    meshes, bsdfs, emitters = tuple(meshes), tuple(bsdfs), tuple(emitters)
    device = resolve_device(device)
    if analytic is not None and analytic.n_prims == 0:
        analytic = None
    instances = tuple(instances) if instances else ()
    for g in instances:
        if any(e >= 0 for e in g.emitter_of_submesh):
            raise ValueError(f"instanced group {g.id!r}: emitters inside "
                             "shape groups are not supported")
    ana_bsdf = tuple(analytic.bsdf_index) if analytic is not None else ()
    ana_emitter = tuple(analytic.emitter_index) if analytic is not None \
        else ()
    analytic_base = len(meshes) + (sdf is not None)

    def owner(e):
        s = next((s for s, m in enumerate(meshes) if m.emitter_index == e), -1)
        if s < 0 and e in ana_emitter:
            s = analytic_base + ana_emitter.index(e)
        return s

    emitter_shape = tuple(owner(e) for e in range(len(emitters)))
    # scene bounding sphere, in float32 as the JAX package computes it
    pts = [m.vertices.detach().cpu().numpy() for m in meshes]
    if analytic is not None:
        pts.append(analytic.bound_points())
    pts += [b.cpu().numpy() for g in instances for b in (g.world_lo,
                                                         g.world_hi)]
    if sdf is not None:
        pts.append(torch.stack([sdf.bbox_min, sdf.bbox_max]).detach()
                   .cpu().numpy())
    all_v = np.concatenate(pts)
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
        shape_bsdf=(tuple(int(m.bsdf_index) for m in meshes)
                    + ((int(sdf.bsdf_index),) if sdf is not None else ())
                    + ana_bsdf
                    + tuple(b for g in instances for b in g.bsdf_of_submesh)),
        shape_emitter=(tuple(int(m.emitter_index) for m in meshes)
                       + ((-1,) if sdf is not None else ()) + ana_emitter
                       + (-1,) * sum(g.n_submeshes for g in instances)),
        emitter_shape=emitter_shape,
        scene_center=tuple(float(c) for c in center),
        scene_radius=radius,
        face_distrs=tuple(
            DiscreteDistribution.create(meshes[s].face_areas())
            if 0 <= s < len(meshes) else None for s in emitter_shape),
        emitter_distr=DiscreteDistribution.create(
            torch.tensor(weights, device=device)),
        env_index=env_index,
        scene_analytic=analytic,
        scene_sdf=sdf,
        instances=instances,
        integrator=integrator,
    )
    if sum(int(m.faces.shape[0]) for m in meshes) > MAX_FACES:
        v, f = scene.geometry()[:2]
        scene.accel = build_bvh(v.cpu().numpy(), f.cpu().numpy(),
                                device=device)
    return scene
