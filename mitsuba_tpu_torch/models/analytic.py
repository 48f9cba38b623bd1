"""Analytic primitives: exact spheres, disks, cylinders and curves
(mitsuba_tpu/models/analytic.py; reference src/shapes/sphere.cpp,
disk.cpp, cylinder.cpp, linearcurve.cpp and bsplinecurve.cpp).

All analytic prims of a scene live in one ``AnalyticShapes`` of
per-type parameter tensors, in the JAX package's global prim order:
spheres, then disks, then cylinders, then curves.  A curve prim is one
swept-sphere segment: a linear curve's segment is the rounded cone from
(pa, ra) to (pb, rb); a cubic B-spline's parent segment is flattened
into ``subdiv`` sub-segments whose rounded cone, inflated by the
flattening bound ``cv_pad``, only seeds a Newton solve on the true canal
surface of the parent's four control points and radii (``cv_cp``,
``cv_cr``, the window [``cv_w0``, ``cv_w1``] of its parameter).

- ``intersect`` is the detached closest hit, a dense (N, K) sweep per
  type in plain PyTorch (K is a handful of prims), reduced by
  ``min`` / ``argmin`` (ties to the first prim, as ``jnp.argmin``).
  The curves are swept ``CURVE_PAIRS`` (lane, prim) pairs at a time,
  lanes in chunks, and the cubic Newton solve runs only on the pairs
  whose inflated tube the ray hits (the dense sweep's values on them;
  the other pairs it masks out).  The scene merges the sweep after the
  mesh query (#1 or #5), and ORs ``any_hit`` into the shadow query (#1
  or #6).
- ``compute_si`` re-derives the differentiable interaction from the
  detached hit in the three RayFlags modes (interaction.h:19-68):
  ``attach`` re-solves t from the attached quadratic or plane, nearest
  the detached t (a cubic curve: one implicit-function step against the
  attached canal surface); ``follow_shape`` keeps the detached local
  parameterisation and rebuilds the point from the attached parameters;
  ``detach_shape`` detaches the shape.  Unlike the JAX package, which
  evaluates every type on every lane and merges with ``where``, each
  type (linear and cubic curves apart) runs on its own lanes only, so a
  lane's unused branch cannot put 0 * inf = NaN into the backward; the
  poles' ``acos`` and the axis' ``atan2`` get a zero gradient where
  theirs is infinite.  The curves' parameters are gathered per lane by
  ``ops/gather.py::gather_rows``, whose backward repeats bit for bit.
- ``SphereGeom`` is the area light of an analytic sphere: uniform
  positions, and the reference's solid-angle cone sampling
  (sphere.cpp:236-325).

The float32 formulas are the JAX package's, in its order (b = L.d over
a non-unit d, 1 / max(a, 1e-20)): the per-lane parity depends on it.
Trigonometric functions are rounded from float64 (``via_f64``), the same
bits on the CPU and the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import warp
from ..core.math import (Frame, coordinate_system, dot, normalize, safe_sqrt,
                         sqr, sqrt, via_f64)
from ..core.records import PositionSample, Ray, SurfaceInteraction
from ..ops.gather import gather_rows

_TWO_PI = 2.0 * math.pi
# (lane, curve prim) pairs of one step of the curve sweep: a float32
# temporary of the step is 32 MiB
CURVE_PAIRS = 1 << 23
_CUBIC_ITERS = 10
_SIXTH = 1.0 / 6.0


def _acos(x):
    """acos of x in [-1, 1], its gradient 0 at +-1 where acos' is
    infinite (the value is acos' own)."""
    inner = torch.abs(x) < 1.0
    return torch.where(inner, via_f64(torch.acos, torch.where(inner, x, 0.0)),
                       via_f64(torch.acos, x.detach()))


def _atan2(y, x):
    """atan2(y, x), 0 at the origin with a zero gradient there."""
    nz = (x != 0.0) | (y != 0.0)
    ys, xs = torch.where(nz, y, 0.0), torch.where(nz, x, 1.0)
    a = torch.atan2(ys.double(), xs.double()).to(y.dtype)
    return torch.where(nz, a, 0.0)


def _phi(y, x):
    """The azimuth atan2(y, x) in [0, 2 pi)."""
    phi = _atan2(y, x)
    return torch.where(phi < 0.0, phi + _TWO_PI, phi)


@dataclass
class AnalyticShapes:
    """Batched analytic primitives (the JAX package's field names and
    global prim order: spheres, disks, cylinders, curves)."""

    sp_center: torch.Tensor    # (S, 3)
    sp_radius: torch.Tensor    # (S,)
    dk_center: torch.Tensor    # (D, 3)
    dk_su: torch.Tensor        # (D, 3) scaled u axis (ellipse support)
    dk_sv: torch.Tensor        # (D, 3) scaled v axis
    dk_n: torch.Tensor         # (D, 3) unit normal
    cy_p0: torch.Tensor        # (C, 3) base point
    cy_axis: torch.Tensor      # (C, 3) unit axis
    cy_len: torch.Tensor       # (C,)
    cy_radius: torch.Tensor    # (C,)
    # the curve segments (one swept sphere each) and, for the cubic ones,
    # their parent B-spline segment
    cv_pa: torch.Tensor        # (K, 3)
    cv_pb: torch.Tensor        # (K, 3)
    cv_ra: torch.Tensor        # (K,)
    cv_rb: torch.Tensor        # (K,)
    cv_u0: torch.Tensor        # (K,) global curve parameter at pa
    cv_u1: torch.Tensor        # (K,) global curve parameter at pb
    cv_cp: torch.Tensor        # (K, 4, 3) the parent's control points
    cv_cr: torch.Tensor        # (K, 4) and radii
    cv_w0: torch.Tensor        # (K,) the window of the parent's parameter
    cv_w1: torch.Tensor        # (K,)
    cv_pad: torch.Tensor       # (K,) the candidate tube's inflation
    cv_cubic: torch.Tensor     # (K,) 1.0 for a cubic prim, 0.0 linear
    # per-prim metadata in global prim order
    bsdf_index: tuple = ()
    emitter_index: tuple = ()
    flip_normals: tuple = ()
    ids: tuple = ()
    any_cubic: bool = False

    # ------------------------------------------------------------ counts

    @property
    def n_spheres(self):
        return int(self.sp_center.shape[0])

    @property
    def n_disks(self):
        return int(self.dk_center.shape[0])

    @property
    def n_cylinders(self):
        return int(self.cy_p0.shape[0])

    @property
    def n_curves(self):
        return int(self.cv_pa.shape[0])

    @property
    def n_prims(self):
        return (self.n_spheres + self.n_disks + self.n_cylinders
                + self.n_curves)

    @property
    def device(self):
        return self.sp_center.device

    def _flip_arr(self):
        return torch.tensor(self.flip_normals, dtype=torch.float32,
                            device=self.device)

    def bound_points(self):
        """Conservative corner points (numpy) for the scene's bounding
        sphere (make_scene)."""
        def np_(x):
            return x.detach().cpu().numpy()

        pts = []
        if self.n_spheres:
            c, r = np_(self.sp_center), np_(self.sp_radius)[:, None]
            pts += [c - r, c + r]
        if self.n_disks:
            c = np_(self.dk_center)
            e = np.abs(np_(self.dk_su)) + np.abs(np_(self.dk_sv))
            pts += [c - e, c + e]
        if self.n_cylinders:
            p0, ax = np_(self.cy_p0), np_(self.cy_axis)
            ln, r = np_(self.cy_len)[:, None], np_(self.cy_radius)[:, None]
            pts += [p0 - r, p0 + r, p0 + ax * ln - r, p0 + ax * ln + r]
        if self.n_curves:
            pa, pb = np_(self.cv_pa), np_(self.cv_pb)
            ra, rb = np_(self.cv_ra)[:, None], np_(self.cv_rb)[:, None]
            pts += [pa - ra, pa + ra, pb - rb, pb + rb]
        return (np.concatenate(pts) if pts
                else np.zeros((0, 3), np.float32))

    # -------------------------------------------------- detached traversal

    def intersect(self, o, d, maxt, active):
        """Detached closest hit over every analytic prim: (t (N,), prim
        (N,) int64), t = inf on a miss, prim the global analytic index."""
        n = o.shape[0]
        best_t = torch.full((n,), math.inf, device=o.device)
        best_p = torch.zeros(n, dtype=torch.int64, device=o.device)

        def consider(t_k, first):
            nonlocal best_t, best_p
            t_min, k_min = torch.min(t_k, dim=1)
            closer = t_min < best_t
            best_t = torch.where(closer, t_min, best_t)
            best_p = torch.where(closer, first + k_min, best_p)

        oo, dd, mt, act = o[:, None, :], d[:, None, :], maxt[:, None], \
            active[:, None]
        if self.n_spheres:
            t_near, t_far, _ = _sphere_roots(oo, dd, self.sp_center[None],
                                             self.sp_radius[None])
            consider(_first_valid(t_near, t_far, mt, act), 0)
        if self.n_disks:
            t, x, y = _disk_hit(oo, dd, self.dk_center[None], self.dk_su[None],
                                self.dk_sv[None], self.dk_n[None])
            ok = act & (t > 0.0) & (t <= mt) & (x * x + y * y <= 1.0)
            consider(torch.where(ok, t, math.inf), self.n_spheres)
        if self.n_cylinders:
            t0, t1, z0, z1 = _cylinder_roots(oo, dd, self.cy_p0[None],
                                             self.cy_axis[None],
                                             self.cy_radius[None])
            ln = self.cy_len[None]
            ok0 = (z0 >= 0.0) & (z0 <= ln)
            ok1 = (z1 >= 0.0) & (z1 <= ln)
            consider(_first_valid(torch.where(ok0, t0, math.inf),
                                  torch.where(ok1, t1, math.inf), mt, act),
                     self.n_spheres + self.n_disks)
        if self.n_curves:
            t_cv, k_cv = self._curve_sweep(o, d, maxt, active)
            closer = t_cv < best_t
            best_t = torch.where(closer, t_cv, best_t)
            best_p = torch.where(closer, self.n_spheres + self.n_disks
                                 + self.n_cylinders + k_cv, best_p)
        return best_t, best_p

    def _curve_sweep(self, o, d, maxt, active):
        """The curves' closest hit per lane, (t, curve index), in chunks
        of at most CURVE_PAIRS (lane, prim) pairs: a lane's prims are
        swept together, so the merge is the dense sweep's."""
        k = self.n_curves
        pad = (self.cv_pad if self.any_cubic
               else torch.zeros(k, device=o.device))[None]
        ra, rb = self.cv_ra[None] + pad, self.cv_rb[None] + pad
        step = max(1, CURVE_PAIRS // k)
        ts, ks = [], []
        for i in range(0, o.shape[0], step):
            oo, dd = o[i:i + step, None, :], d[i:i + step, None, :]
            mt, act = maxt[i:i + step, None], active[i:i + step, None]
            # cubic prims inflate the flattened tube by the flattening
            # bound so the candidate cannot miss a bulge; the exact
            # Newton solve then replaces the candidate
            tk = _rounded_cone_first(oo, dd, self.cv_pa[None],
                                     self.cv_pb[None], ra, rb, mt, act)
            if self.any_cubic:
                t_cub = _cubic_first(oo, dd, self.cv_cp[None],
                                     self.cv_cr[None], self.cv_w0[None],
                                     self.cv_w1[None], mt, act, tk)
                tk = torch.where(self.cv_cubic[None] > 0.5, t_cub, tk)
            t_min, k_min = torch.min(tk, dim=1)
            ts.append(t_min)
            ks.append(k_min)
        return torch.cat(ts), torch.cat(ks)

    def any_hit(self, o, d, maxt, active):
        t, _ = self.intersect(o, d, maxt, active)
        return torch.isfinite(t) & active

    # --------------------------------------------- differentiable rebuild

    def compute_si(self, ray, t_det, prim, valid, mode="attach",
                   shape_slot_base=0):
        """Differentiable SurfaceInteraction from the detached hit (t_det,
        prim) on the lanes ``valid`` (sphere.cpp:614 and the disk and
        cylinder analogues), in ``mode`` attach | follow_shape |
        detach_shape.  Lanes off ``valid`` carry t = inf and placeholder
        fields."""
        if mode not in ("attach", "follow_shape", "detach_shape"):
            raise ValueError(f"unknown compute_si mode {mode!r}")
        n, dev = ray.o.shape[0], ray.o.device
        t = torch.where(valid, t_det, 1.0)
        p_det = ray.o.detach() + ray.d.detach() * t[:, None]
        flip = self._flip_arr()[torch.clamp(prim, 0, self.n_prims - 1)]
        sign = 1.0 - 2.0 * flip
        t_a, p = t, p_det
        ng = torch.zeros((n, 3), device=dev)
        ng[:, 2] = 1.0
        uv = torch.zeros((n, 2), device=dev)
        # (first prim, lanes of the type, its interaction); the curves'
        # linear and cubic prims apart
        b_dk = self.n_spheres
        b_cy = b_dk + self.n_disks
        b_cv = b_cy + self.n_cylinders
        kinds = [(0, prim < b_dk, self._sphere_si),
                 (b_dk, (prim >= b_dk) & (prim < b_cy), self._disk_si),
                 (b_cy, (prim >= b_cy) & (prim < b_cv), self._cylinder_si)]
        if self.n_curves:
            on = prim >= b_cv
            cubic = on & (self.cv_cubic > 0.5)[torch.clamp(
                prim - b_cv, 0, self.n_curves - 1)]
            kinds += [(b_cv, on & ~cubic, self._curve_si),
                      (b_cv, cubic, self._curve_si_cubic)]
        for first, lanes, si_fn in kinds:
            idx = torch.nonzero(valid & lanes).squeeze(1)
            if idx.numel():
                sub = Ray(o=ray.o[idx], d=ray.d[idx], maxt=ray.maxt[idx])
                fields = si_fn(sub, t[idx], p_det[idx], prim[idx] - first,
                               mode)
                t_a, p, ng, uv = (base.index_copy(0, idx, f) for base, f in
                                  zip((t_a, p, ng, uv), fields))
        ng = ng * sign[:, None]
        s, tt, _ = Frame.from_normal(ng)
        return SurfaceInteraction(
            t=torch.where(valid, t_a, math.inf), p=p, n=ng, sh_n=ng, sh_s=s,
            sh_t=tt, uv=uv, wi=Frame.to_local((s, tt, ng), -ray.d),
            shape_index=torch.where(valid, shape_slot_base + prim, -1),
            prim_index=torch.zeros(n, dtype=torch.int64, device=dev),
            wavelengths=ray.wavelengths)

    # ---- per-type interactions on their own lanes: (t, p, n_geo, uv)

    def _sphere_si(self, ray, t_det, p_det, j, mode):
        c, r = self.sp_center[j], self.sp_radius[j]
        if mode == "detach_shape":
            c, r = c.detach(), r.detach()
        if mode == "follow_shape":
            # rigid attachment: the local unit direction detached
            dir0 = normalize(p_det - c.detach()).detach()
            p = c + dir0 * r[:, None]
            t = _t_from_point(ray, p)
            nloc = dir0
        else:
            t_near, t_far, _ = _sphere_roots(ray.o, ray.d, c, r)
            t = torch.where(torch.abs(t_near - t_det)
                            <= torch.abs(t_far - t_det), t_near, t_far)
            t = torch.where(torch.isfinite(t), t, t_det)
            p = ray.o + ray.d * t[:, None]
            nloc = (p - c) / torch.clamp(r, min=1e-20)[:, None]
        # uv = (phi / 2 pi, theta / pi) of the object-space direction
        # (sphere.cpp:677-684)
        src = nloc.detach() if mode == "follow_shape" else nloc
        theta = _acos(torch.clamp(src[:, 2], -1.0, 1.0))
        uv = torch.stack([_phi(src[:, 1], src[:, 0]) / _TWO_PI,
                          theta / math.pi], dim=-1)
        return t, p, normalize(nloc), uv

    def _disk_si(self, ray, t_det, p_det, j, mode):
        c, su, sv, nrm = (self.dk_center[j], self.dk_su[j], self.dk_sv[j],
                          self.dk_n[j])
        if mode == "detach_shape":
            c, su, sv, nrm = c.detach(), su.detach(), sv.detach(), nrm.detach()
        if mode == "follow_shape":
            xy = _disk_local(p_det, c.detach(), su.detach(),
                             sv.detach()).detach()
            p = c + su * xy[:, 0:1] + sv * xy[:, 1:2]
            t = _t_from_point(ray, p)
        else:
            denom = dot(ray.d, nrm)
            safe = torch.abs(denom) > 1e-12
            t = torch.where(safe, dot(c - ray.o, nrm)
                            / torch.where(safe, denom, 1.0), t_det)
            p = ray.o + ray.d * t[:, None]
            xy = _disk_local(p, c, su, sv)
        x, y = xy[:, 0], xy[:, 1]
        # uv = (r, phi / 2 pi) (disk.cpp:189)
        uv = torch.stack([safe_sqrt(x * x + y * y), _phi(y, x) / _TWO_PI],
                         dim=-1)
        return t, p, normalize(nrm.expand_as(p)), uv

    def _cylinder_si(self, ray, t_det, p_det, j, mode):
        p0, ax, ln, r = (self.cy_p0[j], self.cy_axis[j], self.cy_len[j],
                         self.cy_radius[j])
        if mode == "detach_shape":
            p0, ax, ln, r = p0.detach(), ax.detach(), ln.detach(), r.detach()
        if mode == "follow_shape":
            p0d, axd = p0.detach(), ax.detach()
            rel0 = p_det - p0d
            z0 = dot(rel0, axd)
            zfrac = (z0 / torch.clamp(ln.detach(), min=1e-20)).detach()
            rad0 = normalize(rel0 - axd * z0[:, None]).detach()
            p = p0 + ax * (zfrac * ln)[:, None] + rad0 * r[:, None]
            t = _t_from_point(ray, p)
            z = zfrac * ln
            radial = rad0 * r[:, None]
        else:
            t0, t1, _, _ = _cylinder_roots(ray.o, ray.d, p0, ax, r)
            t = torch.where(torch.abs(t0 - t_det) <= torch.abs(t1 - t_det),
                            t0, t1)
            t = torch.where(torch.isfinite(t), t, t_det)
            p = ray.o + ray.d * t[:, None]
            rel = p - p0
            z = dot(rel, ax)
            radial = rel - ax * z[:, None]
        # uv = (phi / 2 pi, z / length) (cylinder.cpp)
        su, sv = coordinate_system(ax.detach())
        uv = torch.stack([_phi(dot(radial, sv), dot(radial, su)) / _TWO_PI,
                          z / torch.clamp(ln, min=1e-20)], dim=-1)
        return t, p, normalize(radial), uv

    def _curve_si(self, ray, t_det, p_det, j, mode):
        """A linear curve segment's interaction (the rounded cone from
        (pa, ra) to (pb, rb)): the hit classifies by its detached axial
        coordinate into cap a, side or cap b, and the position and normal
        are re-derived from the segment's attached end points and radii;
        uv = (the global curve parameter, the azimuth about the
        segment)."""
        pa, pb = gather_rows(self.cv_pa, j), gather_rows(self.cv_pb, j)
        ra, rb = gather_rows(self.cv_ra, j), gather_rows(self.cv_rb, j)
        u0, u1 = self.cv_u0[j], self.cv_u1[j]
        if mode == "detach_shape":
            pa, pb, ra, rb = pa.detach(), pb.detach(), ra.detach(), rb.detach()
        ba = pb - pa
        m0 = dot(ba, ba)
        rr = ra - rb
        d2 = torch.clamp(m0 - rr * rr, min=1e-20)
        # the detached axial coordinate of the tangency point: (0, d2) is
        # the side, outside it the end spheres
        y_det = dot(p_det - pa.detach(), ba.detach()) \
            - ra.detach() * rr.detach()
        s_loc = torch.clamp((y_det / d2).detach(), 0.0, 1.0)
        if mode == "follow_shape":
            # rigid reattachment: detached local parameters, attached frame
            c0 = pa.detach() + ba.detach() * s_loc[:, None]
            rad0 = normalize(p_det - c0).detach()
            c = pa + ba * s_loc[:, None]
            r = ra + (rb - ra) * s_loc
            p = c + rad0 * r[:, None]
            t = _t_from_point(ray, p)
            ng = rad0
        else:
            # the attached quadratic's root nearest the detached t
            t0, t1, _ = _rounded_cone_roots(ray.o, ray.d, pa, pb, ra, rb)
            side = (y_det > 0.0) & (y_det < d2)
            t_side = torch.where(torch.abs(t0 - t_det)
                                 <= torch.abs(t1 - t_det), t0, t1)
            cap_a = (y_det <= 0.0)
            cap_c = torch.where(cap_a[:, None], pa, pb)
            cap_r = torch.where(cap_a, ra, rb)
            tc0, tc1, _ = _sphere_roots(ray.o, ray.d, cap_c, cap_r)
            t_cap = torch.where(torch.abs(tc0 - t_det)
                                <= torch.abs(tc1 - t_det), tc0, tc1)
            t = torch.where(side, t_side, t_cap)
            t = torch.where(torch.isfinite(t), t, t_det)
            p = ray.o + ray.d * t[:, None]
            oa = p - pa
            y = dot(oa, ba) - ra * rr
            n_side = d2[:, None] * oa - ba * y[:, None]
            n_cap = p - cap_c
            ng = normalize(torch.where(side[:, None], n_side, n_cap))
        su, sv = coordinate_system(normalize(ba.detach()))
        rel = p - (pa + ba * s_loc[:, None])
        u_glob = u0 + (u1 - u0) * s_loc
        uv = torch.stack([u_glob, _phi(dot(rel, sv), dot(rel, su)) / _TWO_PI],
                         dim=-1)
        return t, p, ng, uv

    def _curve_si_cubic(self, ray, t_det, p_det, j, mode):
        """A cubic B-spline sub-segment's interaction (bsplinecurve.cpp
        compute_surface_interaction): the envelope foot s* re-solved by a
        detached Newton from the hit, the normal the touching sphere's
        (p - c(s*)) / r(s*), and in attach mode one implicit-function step
        of t against the attached canal surface; uv = (the global curve
        parameter, the azimuth about the detached tangent)."""
        cp, cr = gather_rows(self.cv_cp, j), gather_rows(self.cv_cr, j)
        w0, w1 = self.cv_w0[j], self.cv_w1[j]
        u0, u1 = self.cv_u0[j], self.cv_u1[j]
        if mode == "detach_shape":
            cp, cr = cp.detach(), cr.detach()
        cp_d, cr_d = cp.detach(), cr.detach()
        # the detached envelope foot from the detached hit
        pa = _bspline_eval(cp_d, cr_d, w0)[0]
        pb = _bspline_eval(cp_d, cr_d, w1)[0]
        ba = pb - pa
        m0 = torch.clamp(_sum_last(ba * ba), min=1e-20)
        frac = torch.clamp(_sum_last((p_det - pa) * ba) / m0, 0.0, 1.0)
        s0 = w0 + frac * (w1 - w0)
        o_d, d_d = ray.o.detach(), ray.d.detach()
        t_s, s_s, F1_s, scale = _cubic_newton(o_d, d_d, cp_d, cr_d,
                                              t_det.detach(), s0)
        s_cl = torch.clamp(s_s, 0.0, 1.0)
        side = ((torch.abs(F1_s) <= 1e-3 * scale)
                & (s_s > 1e-3) & (s_s < 1.0 - 1e-3)
                & (torch.abs(t_s - t_det) < 0.5 * torch.abs(t_det) + 1e-3))
        # a cap: the nearer parent end of the foot
        s_cap = torch.where(s_cl < 0.5, 0.0, 1.0)
        s_det = torch.where(side, s_cl, s_cap)
        c_att, c1_att, _, r_att, _, _ = _bspline_eval(cp, cr, s_det)
        if mode == "follow_shape":
            c_det0 = _bspline_eval(cp_d, cr_d, s_det)[0]
            rad0 = normalize(p_det - c_det0).detach()
            p = c_att + rad0 * r_att[:, None]
            t = _t_from_point(ray, p)
            ng = rad0
        else:
            # the side: one implicit-function correction of t against the
            # attached canal surface (dF1/ds = 0 on the envelope, so the
            # correction along t alone is exact to first order)
            ev = _bspline_eval(cp, cr, s_det.detach())
            c_att2, r_att2 = ev[0], ev[3]
            q_att = ray.o + ray.d * t_s.detach()[:, None] - c_att2
            F1_att = _sum_last(q_att * q_att) - r_att2 * r_att2
            J11 = 2.0 * _sum_last(q_att.detach() * ray.d)
            J11 = torch.where(torch.abs(J11) > 1e-9, J11,
                              torch.where(J11 >= 0, 1e-9, -1e-9))
            t_side = t_s.detach() - F1_att / J11
            # a cap: the attached sphere's root nearest the detached t
            tc0, tc1, _ = _sphere_roots(ray.o, ray.d, c_att2, r_att2)
            t_cap = torch.where(torch.abs(tc0 - t_det)
                                <= torch.abs(tc1 - t_det), tc0, tc1)
            t = torch.where(side, t_side, t_cap)
            t = torch.where(torch.isfinite(t), t, t_det)
            p = ray.o + ray.d * t[:, None]
            ng = normalize(p - c_att2)
        u_glob = u0 + (u1 - u0) * (s_det - w0) / torch.clamp(w1 - w0,
                                                             min=1e-9)
        su, sv = coordinate_system(normalize(c1_att).detach())
        rel = p - c_att
        uv = torch.stack([u_glob, _phi(dot(rel, sv), dot(rel, su)) / _TWO_PI],
                         dim=-1)
        return t, p, ng, uv

    # ------------------------------------------------------ emitter geom

    def sphere_geom(self, prim: int):
        """The light geometry of the emitting sphere ``prim`` (the scene's
        ``_emitter_geom``); only spheres carry area lights."""
        if not 0 <= prim < self.n_spheres:
            raise ValueError("only analytic spheres can carry area emitters")
        return SphereGeom(center=self.sp_center[prim],
                          radius=self.sp_radius[prim])


# ---------------------------------------------------------------- helpers

def _sphere_roots(o, d, c, r):
    """Both roots of |o + t d - c| = r for a non-unit d: (t_near, t_far,
    disc >= 0), inf where the discriminant is negative."""
    L = c - o
    a = dot(d, d)
    b = dot(L, d)
    disc = sqr(b) - a * (dot(L, L) - sqr(r))
    sq = safe_sqrt(disc)
    ok = disc >= 0.0
    inv_a = 1.0 / torch.clamp(a, min=1e-20)
    return (torch.where(ok, (b - sq) * inv_a, math.inf),
            torch.where(ok, (b + sq) * inv_a, math.inf), ok)


def _cylinder_roots(o, d, p0, ax, r):
    """Roots of the infinite cylinder's quadratic and their axial
    coordinates (t0, t1, z0, z1); an axis-parallel ray gives inf."""
    rel = o - p0
    doa = dot(d, ax)
    ooa = dot(rel, ax)
    d_perp = d - ax * doa[..., None]
    o_perp = rel - ax * ooa[..., None]
    a = dot(d_perp, d_perp)
    b = 2.0 * dot(o_perp, d_perp)
    cc = dot(o_perp, o_perp) - sqr(r)
    disc = sqr(b) - 4.0 * a * cc
    ok = (disc >= 0.0) & (a > 1e-12)
    sq = safe_sqrt(disc)
    inv2a = 1.0 / torch.clamp(2.0 * a, min=1e-12)
    t0 = torch.where(ok, (-b - sq) * inv2a, math.inf)
    t1 = torch.where(ok, (-b + sq) * inv2a, math.inf)
    z0 = ooa + torch.where(torch.isfinite(t0), t0, 0.0) * doa
    z1 = ooa + torch.where(torch.isfinite(t1), t1, 0.0) * doa
    return t0, t1, z0, z1


def _sum_last(x):
    """The sum over the last dimension, first to last (``dot``'s order)."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _rounded_cone_roots(o, d, pa, pb, ra, rb):
    """Both roots of the side surface of the swept sphere from (pa, ra)
    to (pb, rb), the cone tangent to both end spheres: with ba = pb - pa,
    rr = ra - rb and d2 = |ba|^2 - rr^2, k2 t^2 + 2 k1 t + k0 = 0, every
    term explicit for a non-unit d.  Returns (t0, t1, (y0, y1, d2)), y
    the roots' axial coordinates (the side is 0 < y < d2); the roots are
    inf where there is none, not masked to the side."""
    ba = pb - pa
    oa = o - pa
    rr = ra - rb
    m0 = dot(ba, ba)
    m1 = dot(ba, oa)
    m2 = dot(ba, d)
    m3 = dot(oa, d)
    m5 = dot(oa, oa)
    md = dot(d, d)
    d2 = torch.clamp(m0 - rr * rr, min=1e-20)
    k2 = d2 * md - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra - m0 * ra * ra
    disc = k1 * k1 - k0 * k2
    ok = (disc >= 0.0) & (torch.abs(k2) > 1e-20)
    sq = safe_sqrt(torch.clamp(disc, min=0.0))
    inv = 1.0 / torch.where(ok, k2, 1.0)
    t0 = torch.where(ok, (-k1 - sq) * inv, math.inf)
    t1 = torch.where(ok, (-k1 + sq) * inv, math.inf)
    y0 = m1 - ra * rr + t0 * m2
    y1 = m1 - ra * rr + t1 * m2
    return t0, t1, (y0, y1, d2)


def _rounded_cone_first(o, d, pa, pb, ra, rb, maxt, active):
    """The first hit in (0, maxt] of the whole rounded cone, its side and
    both end spheres, inf for a miss.  Each end sphere counts only on
    its exposed cap (y <= 0 at pa, y >= d2 at pb, the axial coordinate
    of the side), so that a ray starting inside the tube exits through
    the true surface."""
    ba = pb - pa
    rr = ra - rb
    m1 = dot(ba, o - pa)
    m2 = dot(ba, d)
    yb = m1 - ra * rr          # y(t) = yb + t * m2, the side's coordinate
    t0, t1, (y0, y1, d2) = _rounded_cone_roots(o, d, pa, pb, ra, rb)
    ok0 = (y0 > 0.0) & (y0 < d2)
    ok1 = (y1 > 0.0) & (y1 < d2)
    cand = _first_valid(torch.where(ok0, t0, math.inf),
                        torch.where(ok1, t1, math.inf), maxt, active)

    def cap(tc0, tc1, lo_cap):
        yc0 = yb + tc0 * m2
        yc1 = yb + tc1 * m2
        in0 = (yc0 <= 0.0) if lo_cap else (yc0 >= d2)
        in1 = (yc1 <= 0.0) if lo_cap else (yc1 >= d2)
        return torch.where(in0, tc0, math.inf), torch.where(in1, tc1, math.inf)

    ta0, ta1, _ = _sphere_roots(o, d, pa, ra)
    ca = _first_valid(*cap(ta0, ta1, True), maxt, active)
    tb0, tb1, _ = _sphere_roots(o, d, pb, rb)
    cb = _first_valid(*cap(tb0, tb1, False), maxt, active)
    return torch.minimum(cand, torch.minimum(ca, cb))


def _bspline_eval(cp, cr, s):
    """A uniform cubic B-spline segment and its first two derivatives at
    ``s`` (the basis of ``shapes.bspline_centerline``, bsplinecurve.cpp's):
    ``cp`` (..., 4, 3), ``cr`` (..., 4), ``s`` (...) -> (c, c', c'', r,
    r', r'')."""
    # x * (1 / 6), not x / 6: the card divides a tensor by a scalar as a
    # multiplication by its reciprocal and the CPU does not, and a weight
    # an ulp apart moves the Newton solve's bits, and so a lane's path
    s2 = s * s
    s3 = s2 * s
    w = torch.stack([1.0 - 3.0 * s + 3.0 * s2 - s3,
                     3.0 * s3 - 6.0 * s2 + 4.0,
                     -3.0 * s3 + 3.0 * s2 + 3.0 * s + 1.0,
                     s3], dim=-1) * _SIXTH
    dw = torch.stack([-3.0 + 6.0 * s - 3.0 * s2,
                      9.0 * s2 - 12.0 * s,
                      -9.0 * s2 + 6.0 * s + 3.0,
                      3.0 * s2], dim=-1) * _SIXTH
    ddw = torch.stack([6.0 - 6.0 * s,
                       18.0 * s - 12.0,
                       -18.0 * s + 6.0,
                       6.0 * s], dim=-1) * _SIXTH

    def pts(wt):
        return _sum_last((wt[..., None] * cp).transpose(-1, -2))

    return (pts(w), pts(dw), pts(ddw), _sum_last(w * cr), _sum_last(dw * cr),
            _sum_last(ddw * cr))


def _cubic_newton(o, d, cp, cr, t0, s0, iters=_CUBIC_ITERS):
    """Newton on the canal surface of the swept sphere along a cubic
    B-spline segment (bsplinecurve.cpp's iterative solve), from (t0, s0):

        F1(t, s) = |o + t d - c(s)|^2 - r(s)^2       (on the sphere)
        F2(t, s) = (o + t d - c(s)) . c'(s) + r r'   (the envelope foot)

    dF1/ds = -2 F2, so near the solution the system is triangular.  The
    steps are damped (|ds| <= 0.25, |dt| <= 4 r) and s kept in [-0.25,
    1.25].  Returns (t, s, F1, scale); the caller masks by |F1| <= tol *
    scale and the ranges of s and t."""
    t, s = t0, s0
    for _ in range(iters):
        c, c1, c2, r, r1, r2 = _bspline_eval(cp, cr, s)
        q = o + t[..., None] * d - c
        F1 = _sum_last(q * q) - r * r
        F2 = _sum_last(q * c1) + r * r1
        J11 = 2.0 * _sum_last(q * d)
        J12 = -2.0 * F2
        J21 = _sum_last(d * c1)
        J22 = (-_sum_last(c1 * c1) + _sum_last(q * c2) + r1 * r1 + r * r2)
        det = J11 * J22 - J12 * J21
        big = torch.abs(det) > 1e-20
        inv = torch.where(big, 1.0 / torch.where(big, det, 1.0), 0.0)
        dt = -(F1 * J22 - J12 * F2) * inv
        ds = -(J11 * F2 - J21 * F1) * inv
        ds = torch.clamp(ds, -0.25, 0.25)
        r_sc = torch.clamp(r, min=1e-6)
        dt = torch.clamp(dt, -4.0 * r_sc, 4.0 * r_sc)
        t, s = t + dt, torch.clamp(s + ds, -0.25, 1.25)
    c, c1, _, r, r1, _ = _bspline_eval(cp, cr, s)
    q = o + t[..., None] * d - c
    F1 = _sum_last(q * q) - r * r
    return t, s, F1, torch.clamp(r * r, min=1e-10)


def _cubic_first(o, d, cp, cr, w0, w1, maxt, active, t_init):
    """The first exact cubic hit of each (ray, sub-segment) pair, (n, K):
    the Newton-refined side surface, on the pairs whose inflated
    flattened tube ``t_init`` hits (inf elsewhere), and the parent
    spline's end spheres, exposed beyond the envelope foot, on the first
    (w0 = 0) and last (w1 = 1) sub-segments.  ``o``, ``d`` (n, 1, 3);
    ``cp`` (1, K, 4, 3), ``cr`` (1, K, 4), ``w0``, ``w1`` (1, K); ``maxt``,
    ``active`` (n, 1)."""
    has = torch.isfinite(t_init) & active
    t_side = torch.full_like(t_init, math.inf)
    li, ki = torch.nonzero(has, as_tuple=True)
    if li.numel():
        o_p, d_p = o[li, 0], d[li, 0]
        cp_p, cr_p = cp[0, ki], cr[0, ki]
        w0_p, w1_p = w0[0, ki], w1[0, ki]
        t0 = t_init[li, ki]
        # s from the flattened candidate's axial fraction
        pa = _bspline_eval(cp_p, cr_p, w0_p)[0]
        pb = _bspline_eval(cp_p, cr_p, w1_p)[0]
        ba = pb - pa
        m0 = torch.clamp(_sum_last(ba * ba), min=1e-20)
        ph = o_p + t0[..., None] * d_p
        frac = torch.clamp(_sum_last((ph - pa) * ba) / m0, 0.0, 1.0)
        s0 = w0_p + frac * (w1_p - w0_p)
        t, s, F1, scale = _cubic_newton(o_p, d_p, cp_p, cr_p, t0, s0)
        ok = ((torch.abs(F1) <= 1e-3 * scale)
              & (s >= -1e-3) & (s <= 1.0 + 1e-3)
              & (t > 0.0) & (t <= maxt[li, 0]))
        t_side[li, ki] = torch.where(ok, t, math.inf)

    # the end spheres ("terminated by a spherical endcap"), exposed beyond
    # the envelope foot
    def cap(at_s, outward):
        c, c1, _, r, r1, _ = _bspline_eval(cp, cr, at_s)
        tc0, tc1, _ = _sphere_roots(o, d, c, r)

        def expose(tc):
            q = o + tc[..., None] * d - c
            g = _sum_last(q * c1) + r * r1
            return torch.where((g * outward >= 0.0) & torch.isfinite(tc), tc,
                               math.inf)

        return _first_valid(expose(tc0), expose(tc1), maxt, active)

    inf = torch.full_like(t_side, math.inf)
    t_cap0 = torch.where(w0 <= 1e-6, cap(torch.zeros_like(w0), -1.0), inf)
    t_cap1 = torch.where(w1 >= 1.0 - 1e-6, cap(torch.ones_like(w1), 1.0), inf)
    return torch.minimum(t_side, torch.minimum(t_cap0, t_cap1))


def _first_valid(t0, t1, maxt, active):
    """The nearest of two candidate roots in (0, maxt] (inf: a miss)."""
    t0 = torch.where(active & (t0 > 0.0) & (t0 <= maxt), t0, math.inf)
    t1 = torch.where(active & (t1 > 0.0) & (t1 <= maxt), t1, math.inf)
    return torch.minimum(t0, t1)


def _disk_hit(o, d, c, su, sv, nrm):
    """The plane's hit and the normalised in-disk coordinates (x, y)."""
    denom = dot(d, nrm)
    safe = torch.abs(denom) > 1e-12
    t = torch.where(safe, dot(c - o, nrm) / torch.where(safe, denom, 1.0),
                    math.inf)
    rel = o + d * t[..., None] - c
    x = dot(rel, su) / torch.clamp(dot(su, su), min=1e-20)
    y = dot(rel, sv) / torch.clamp(dot(sv, sv), min=1e-20)
    return t, x, y


def _disk_local(p, c, su, sv):
    rel = p - c
    return torch.stack([dot(rel, su) / torch.clamp(dot(su, su), min=1e-20),
                        dot(rel, sv) / torch.clamp(dot(sv, sv), min=1e-20)],
                       dim=-1)


def _t_from_point(ray, p):
    """Distance of the attached point from the ray's origin in units of
    |d| (the follow_shape t, mesh.cpp:1376)."""
    delta = p - ray.o
    return sqrt(torch.clamp(dot(delta, delta), min=1e-30)
                / torch.clamp(dot(ray.d, ray.d), min=1e-30))


# --------------------------------------------------------- emitter geom

@dataclass
class SphereGeom:
    """The position-sampling protocol of a mesh light (models/shapes.py
    ``Mesh.sample_position*``) for an analytic sphere, plus the
    reference's solid-angle cone sampling (sphere.cpp:236-287), which
    ``AreaEmitter`` takes when it is given this geometry."""

    center: torch.Tensor   # (3,)
    radius: torch.Tensor   # ()

    def surface_area(self):
        return 4.0 * math.pi * sqr(self.radius)

    def _position(self, sample2):
        dir_ = warp.square_to_uniform_sphere(sample2)
        p = self.center[None] + dir_ * self.radius
        pdf = torch.full(sample2.shape[:-1], 1.0, device=sample2.device) \
            / torch.clamp(self.surface_area(), min=1e-20)
        return PositionSample(p=p, n=dir_, uv=sample2, pdf=pdf,
                              delta=torch.zeros(sample2.shape[:-1],
                                                dtype=torch.bool,
                                                device=sample2.device))

    def sample_position(self, sample1, sample2, face_distr=None):
        return self._position(sample2)

    def sample_position_reuse(self, sample2, face_distr=None):
        return self._position(sample2)

    def cone_sample_direction(self, ref_p, sample2):
        """Uniform solid-angle sampling of the sphere as seen from ref_p
        (outside it): (p, n, pdf_sa, outside)."""
        dc_v = self.center[None] - ref_p
        dc_2 = torch.clamp(dot(dc_v, dc_v), min=1e-20)
        inv_dc = 1.0 / sqrt(dc_2)
        outside = dc_2 > sqr(self.radius)
        sin_tm = self.radius * inv_dc
        sin_tm_2 = sqr(sin_tm)
        inv_sin_tm = 1.0 / torch.clamp(sin_tm, min=1e-20)
        cos_tm = safe_sqrt(1.0 - sin_tm_2)
        # the low-distortion mapping, with the reference's Taylor branch
        # for very small cones (sphere.cpp:257-260)
        sin_t2 = torch.where(sin_tm_2 > 0.00068523,
                             1.0 - sqr((cos_tm - 1.0) * sample2[..., 0] + 1.0),
                             sin_tm_2 * sample2[..., 0])
        cos_t = safe_sqrt(1.0 - sin_t2)
        cos_alpha = sin_t2 * inv_sin_tm + cos_t * safe_sqrt(
            1.0 - sin_t2 * sqr(inv_sin_tm))
        sin_alpha = safe_sqrt(1.0 - sqr(cos_alpha))
        phi = sample2[..., 1] * _TWO_PI
        d_loc = torch.stack([via_f64(torch.cos, phi) * sin_alpha,
                             via_f64(torch.sin, phi) * sin_alpha, cos_alpha],
                            dim=-1)
        # +z from the centre toward ref_p: the visible cap
        z = -dc_v * inv_dc[..., None]
        s, t = coordinate_system(z)
        n_world = s * d_loc[..., 0:1] + t * d_loc[..., 1:2] + z * d_loc[..., 2:3]
        p = self.center[None] + n_world * self.radius
        pdf = 1.0 / (_TWO_PI * torch.clamp(1.0 - cos_tm, min=1e-12))
        return p, n_world, pdf, outside

    def cone_pdf_direction(self, ref_p, ds):
        """The solid-angle pdf of ``cone_sample_direction``
        (sphere.cpp:311-325); inside the sphere, the uniform position's
        area pdf converted."""
        dcv = self.center[None] - ref_p
        dc = sqrt(torch.clamp(dot(dcv, dcv), min=1e-20))
        sin_alpha = self.radius / dc
        cos_alpha = safe_sqrt(1.0 - sqr(sin_alpha))
        cone = 1.0 / (_TWO_PI * torch.clamp(1.0 - cos_alpha, min=1e-12))
        cos_e = torch.clamp(-dot(ds.d, ds.n), min=1e-6)
        area = (1.0 / torch.clamp(self.surface_area(), min=1e-20)) \
            * sqr(ds.dist) / cos_e
        return torch.where(sin_alpha < 1.0 - 1e-6, cone, area)


# ------------------------------------------------------------- builders

def _empty(*shape, device):
    return torch.zeros((0,) + shape, dtype=torch.float32, device=device)


def build_analytic(prims, device=None):
    """An ``AnalyticShapes`` from prim descriptors (the JAX package's
    ``build_analytic``; utils/load.py makes them from ``{'analytic':
    True}`` shape dicts, ``analytic_prim`` here), on ``device``:

    ``("sphere", center, radius, bsdf, emitter, flip, id)``
    ``("disk", center, su, sv, n, bsdf, emitter, flip, id)``
    ``("cylinder", p0, axis, length, radius, bsdf, emitter, flip, id)``
    ``("curve", pa, pb, ra, rb, u0, u1, bsdf, emitter, flip, id)``, one a
    linear curve's segment
    ``("cubiccurve", pa, pb, ra, rb, u0, u1, cp4, cr4, w0, w1, pad, bsdf,
    emitter, flip, id)``, one a flattened sub-segment of a cubic
    B-spline's parent segment.

    A list among ``prims`` (a curve's descriptors, as ``analytic_prim``
    returns them) is taken item by item."""
    from ..device import resolve_device

    device = resolve_device(device)
    groups = {"sphere": [], "disk": [], "cylinder": [], "curve": []}
    for p in prims:
        for q in (p if isinstance(p, list) else [p]):
            groups["curve" if q[0] == "cubiccurve" else q[0]].append(q)
    sp, dk, cy, cv = (groups[k] for k in ("sphere", "disk", "cylinder",
                                          "curve"))
    meta = ([p[3:] for p in sp] + [p[5:] for p in dk] + [p[5:] for p in cy]
            + [p[12:] if p[0] == "cubiccurve" else p[7:] for p in cv])

    def arr(rows, i, width=None):
        if not rows:
            return _empty(*((width,) if width else ()), device=device)
        return torch.tensor(np.stack([np.asarray(r[i], np.float32)
                                      for r in rows]), device=device)

    k = len(cv)
    cubic = {"cv_cp": np.zeros((k, 4, 3), np.float32),
             "cv_cr": np.zeros((k, 4), np.float32),
             "cv_w0": np.zeros(k, np.float32), "cv_w1": np.ones(k, np.float32),
             "cv_pad": np.zeros(k, np.float32),
             "cv_cubic": np.zeros(k, np.float32)}
    for j, p in enumerate(cv):
        if p[0] == "cubiccurve":
            for name, i in (("cv_cp", 7), ("cv_cr", 8), ("cv_w0", 9),
                            ("cv_w1", 10), ("cv_pad", 11)):
                cubic[name][j] = np.asarray(p[i], np.float32)
            cubic["cv_cubic"][j] = 1.0
    return AnalyticShapes(
        sp_center=arr(sp, 1, 3), sp_radius=arr(sp, 2),
        dk_center=arr(dk, 1, 3), dk_su=arr(dk, 2, 3), dk_sv=arr(dk, 3, 3),
        dk_n=arr(dk, 4, 3),
        cy_p0=arr(cy, 1, 3), cy_axis=arr(cy, 2, 3), cy_len=arr(cy, 3),
        cy_radius=arr(cy, 4),
        cv_pa=arr(cv, 1, 3), cv_pb=arr(cv, 2, 3), cv_ra=arr(cv, 3),
        cv_rb=arr(cv, 4), cv_u0=arr(cv, 5), cv_u1=arr(cv, 6),
        **{name: torch.tensor(x, device=device) for name, x in cubic.items()},
        bsdf_index=tuple(int(m[0]) for m in meta),
        emitter_index=tuple(int(m[1]) for m in meta),
        flip_normals=tuple(bool(m[2]) for m in meta),
        ids=tuple(str(m[3]) for m in meta),
        any_cubic=any(p[0] == "cubiccurve" for p in cv))


def _bspline_prims(cp, rr, subdiv, meta):
    """The "cubiccurve" descriptors of a B-spline of control points
    ``cp`` and radii ``rr`` (utils/load.py:486-542): its ends clamped,
    each parent segment cut into ``subdiv`` windows whose chord tube is
    inflated by the largest distance of the cubic (centre and radius)
    from it over a 16-times-finer probe, times 1.25, plus 1e-5."""
    cp = np.concatenate([cp[:1], cp, cp[-1:]])
    rr = np.concatenate([rr[:1], rr, rr[-1:]])
    n_par = cp.shape[0] - 3

    def beval(P, R, s):
        s = np.asarray(s, np.float32)
        w4 = np.stack([(1 - s) ** 3 / 6.0,
                       (3 * s ** 3 - 6 * s ** 2 + 4) / 6.0,
                       (-3 * s ** 3 + 3 * s ** 2 + 3 * s + 1) / 6.0,
                       s ** 3 / 6.0], axis=-1)
        return w4 @ P, w4 @ R

    out = []
    total = n_par * subdiv
    ws = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    sd = np.linspace(0.0, 1.0, 16 * subdiv + 1, dtype=np.float32)
    wi = np.clip((sd * subdiv).astype(np.int32), 0, subdiv - 1)
    fr = sd * subdiv - wi
    for i in range(n_par):
        P, R = cp[i:i + 4], rr[i:i + 4]
        pts, rads = beval(P, R, ws)
        cpts, crad = beval(P, R, sd)
        lerp_p = pts[wi] * (1 - fr)[:, None] + pts[wi + 1] * fr[:, None]
        lerp_r = rads[wi] * (1 - fr) + rads[wi + 1] * fr
        pad = float(np.max(np.linalg.norm(cpts - lerp_p, axis=1)
                           + np.abs(crad - lerp_r))) * 1.25 + 1e-5
        for q in range(subdiv):
            k = i * subdiv + q
            out.append(("cubiccurve", pts[q], pts[q + 1], float(rads[q]),
                        float(rads[q + 1]), k / total, (k + 1) / total, P, R,
                        float(ws[q]), float(ws[q + 1]), pad) + meta)
    return out


def analytic_prim(d, bsdf_index=0, emitter_index=-1):
    """The prim descriptor of a ``{'type': 'sphere' | 'disk' |
    'cylinder', ...}`` shape dict (the JAX loader's
    ``_make_analytic_prim``, utils/load.py:424-470): a sphere by
    ``center`` and ``radius``, a disk by ``center`` and ``radius`` in
    the z = 0 plane, a cylinder by ``p0``, ``p1`` and ``radius``; each or
    a ``to_world`` (4, 4) instead (a sphere's and a disk's uniform scale,
    a cylinder's end points and radius transformed);
    ``flip_normals``, ``id``.

    A ``'linearcurve'`` or ``'bsplinecurve'`` (``control_points`` (P, 3),
    ``radius`` one or one a point, default 0.05, ``to_world``; a
    B-spline also ``subdiv``, default 4) gives a list of descriptors, as
    the JAX loader's branches do (utils/load.py:467-542): one a linear
    segment, or ``subdiv`` flattened sub-segments of each parent segment
    of the B-spline, its ends clamped by repeating the first and last
    control points.  ``build_analytic`` takes the list as it is."""
    t = d["type"]
    w = d.get("to_world")
    m = None if w is None else np.asarray(w, np.float32)
    flip = bool(d.get("flip_normals", False))
    sid = d.get("id", t)
    if t == "sphere":
        if m is not None:
            c, r = m[:3, 3], float(np.linalg.norm(m[:3, 0]))
        else:
            c = np.asarray(d.get("center", [0, 0, 0]), np.float32)
            r = float(d.get("radius", 1.0))
        return ("sphere", c, r, bsdf_index, emitter_index, flip, sid)
    if t == "disk":
        if m is not None:
            c, su, sv = m[:3, 3], m[:3, 0], m[:3, 1]
        else:
            c = np.asarray(d.get("center", [0, 0, 0]), np.float32)
            rad = float(d.get("radius", 1.0))
            su = np.asarray([1, 0, 0], np.float32) * rad
            sv = np.asarray([0, 1, 0], np.float32) * rad
        n = np.cross(su, sv)
        n = n / max(float(np.linalg.norm(n)), 1e-20)
        return ("disk", c, su, sv, n, bsdf_index, emitter_index, flip, sid)
    if t == "cylinder":
        p0 = np.asarray(d.get("p0", [0, 0, 0]), np.float32)
        p1 = np.asarray(d.get("p1", [0, 0, 1]), np.float32)
        r = float(d.get("radius", 1.0))
        if m is not None:
            p0 = m[:3, :3] @ p0 + m[:3, 3]
            p1 = m[:3, :3] @ p1 + m[:3, 3]
            r *= float(np.linalg.norm(m[:3, 0]))
        axis = p1 - p0
        length = max(float(np.linalg.norm(axis)), 1e-20)
        return ("cylinder", p0, axis / length, length, r, bsdf_index,
                emitter_index, flip, sid)
    if t in ("linearcurve", "bsplinecurve"):
        cp = np.asarray(d["control_points"], np.float32)
        rr = np.broadcast_to(np.asarray(d.get("radius", 0.05), np.float32),
                             (cp.shape[0],)).astype(np.float32)
        if m is not None:
            cp = cp @ m[:3, :3].T + m[:3, 3]
            rr = rr * float(np.linalg.norm(m[:3, 0]))
        meta = (bsdf_index, emitter_index, flip, sid)
        if t == "linearcurve":
            us = np.linspace(0.0, 1.0, cp.shape[0], dtype=np.float32)
            return [("curve", cp[i], cp[i + 1], float(rr[i]), float(rr[i + 1]),
                     float(us[i]), float(us[i + 1])) + meta
                    for i in range(cp.shape[0] - 1)]
        return _bspline_prims(cp, rr, int(d.get("subdiv", 4)), meta)
    raise ValueError(f"unknown analytic shape type {t!r}")
