"""Analytic primitives: exact spheres, disks and cylinders
(mitsuba_tpu/models/analytic.py; reference src/shapes/sphere.cpp,
disk.cpp, cylinder.cpp).

All analytic prims of a scene live in one ``AnalyticShapes`` of
per-type parameter tensors, in the JAX package's global prim order:
spheres, then disks, then cylinders, then curves.  The curve fields
(``cv_*``) are kept, empty: the curve prims wait for ROADMAP.md Queue 1
item 5c (ii), and ``build_analytic`` raises for them.

- ``intersect`` is the detached closest hit, a dense (N, K) sweep per
  type in plain PyTorch (K is a handful of prims), reduced by
  ``min`` / ``argmin`` (ties to the first prim, as ``jnp.argmin``).
  The scene merges it after the mesh query (#1 or #5), and ORs
  ``any_hit`` into the mesh shadow query (#1 or #6).
- ``compute_si`` re-derives the differentiable interaction from the
  detached hit in the three RayFlags modes (interaction.h:19-68):
  ``attach`` re-solves t from the attached quadratic or plane, nearest
  the detached t; ``follow_shape`` keeps the detached local
  parameterisation and rebuilds the point from the attached parameters;
  ``detach_shape`` detaches the shape.  Unlike the JAX package, which
  evaluates every type on every lane and merges with ``where``, each
  type runs on its own lanes only, so a lane's unused branch cannot put
  0 * inf = NaN into the backward; the poles' ``acos`` and the axis'
  ``atan2`` get a zero gradient where theirs is infinite.
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
                         sqr, via_f64)
from ..core.records import PositionSample, Ray, SurfaceInteraction

_TWO_PI = 2.0 * math.pi

_CURVES_NOT_PORTED = ("analytic curve prims (linear and cubic B-spline "
                      "swept spheres) are not ported yet (ROADMAP.md, Queue "
                      "1, item 5c (ii))")


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
    # the curve segments, empty until Queue 1 item 5c (ii)
    cv_pa: torch.Tensor        # (K, 3)
    cv_pb: torch.Tensor        # (K, 3)
    cv_ra: torch.Tensor        # (K,)
    cv_rb: torch.Tensor        # (K,)
    cv_u0: torch.Tensor        # (K,)
    cv_u1: torch.Tensor        # (K,)
    cv_cp: torch.Tensor        # (K, 4, 3)
    cv_cr: torch.Tensor        # (K, 4)
    cv_w0: torch.Tensor        # (K,)
    cv_w1: torch.Tensor        # (K,)
    cv_pad: torch.Tensor       # (K,)
    cv_cubic: torch.Tensor     # (K,)
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
        return best_t, best_p

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
        first = 0
        for count, si_fn in ((self.n_spheres, self._sphere_si),
                             (self.n_disks, self._disk_si),
                             (self.n_cylinders, self._cylinder_si)):
            idx = torch.nonzero(valid & (prim >= first)
                                & (prim < first + count)).squeeze(1)
            if idx.numel():
                sub = Ray(o=ray.o[idx], d=ray.d[idx], maxt=ray.maxt[idx])
                fields = si_fn(sub, t[idx], p_det[idx], prim[idx] - first,
                               mode)
                t_a, p, ng, uv = (base.index_copy(0, idx, f) for base, f in
                                  zip((t_a, p, ng, uv), fields))
            first += count
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
    return torch.sqrt(torch.clamp(dot(delta, delta), min=1e-30)
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
        inv_dc = 1.0 / torch.sqrt(dc_2)
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
        dc = torch.sqrt(torch.clamp(dot(dcv, dcv), min=1e-20))
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
    True}`` shape dicts), on ``device``:

    ``("sphere", center, radius, bsdf, emitter, flip, id)``
    ``("disk", center, su, sv, n, bsdf, emitter, flip, id)``
    ``("cylinder", p0, axis, length, radius, bsdf, emitter, flip, id)``

    A curve descriptor raises ``NotImplementedError``."""
    from ..device import resolve_device

    device = resolve_device(device)
    groups = {"sphere": [], "disk": [], "cylinder": []}
    for p in prims:
        if p[0] in ("curve", "cubiccurve"):
            raise NotImplementedError(_CURVES_NOT_PORTED)
        groups[p[0]].append(p)
    sp, dk, cy = groups["sphere"], groups["disk"], groups["cylinder"]
    meta = [p[3:] for p in sp] + [p[5:] for p in dk] + [p[5:] for p in cy]

    def arr(rows, i, width=None):
        if not rows:
            return _empty(*((width,) if width else ()), device=device)
        return torch.tensor(np.stack([np.asarray(r[i], np.float32)
                                      for r in rows]), device=device)

    return AnalyticShapes(
        sp_center=arr(sp, 1, 3), sp_radius=arr(sp, 2),
        dk_center=arr(dk, 1, 3), dk_su=arr(dk, 2, 3), dk_sv=arr(dk, 3, 3),
        dk_n=arr(dk, 4, 3),
        cy_p0=arr(cy, 1, 3), cy_axis=arr(cy, 2, 3), cy_len=arr(cy, 3),
        cy_radius=arr(cy, 4),
        cv_pa=_empty(3, device=device), cv_pb=_empty(3, device=device),
        cv_ra=_empty(device=device), cv_rb=_empty(device=device),
        cv_u0=_empty(device=device), cv_u1=_empty(device=device),
        cv_cp=_empty(4, 3, device=device), cv_cr=_empty(4, device=device),
        cv_w0=_empty(device=device), cv_w1=_empty(device=device),
        cv_pad=_empty(device=device), cv_cubic=_empty(device=device),
        bsdf_index=tuple(int(m[0]) for m in meta),
        emitter_index=tuple(int(m[1]) for m in meta),
        flip_normals=tuple(bool(m[2]) for m in meta),
        ids=tuple(str(m[3]) for m in meta))


def analytic_prim(d, bsdf_index=0, emitter_index=-1):
    """The prim descriptor of a ``{'type': 'sphere' | 'disk' |
    'cylinder', ...}`` shape dict (the JAX loader's
    ``_make_analytic_prim``, utils/load.py:424-470): a sphere by
    ``center`` and ``radius``, a disk by ``center`` and ``radius`` in
    the z = 0 plane, a cylinder by ``p0``, ``p1`` and ``radius``; each or
    a ``to_world`` (4, 4) instead (a sphere's and a disk's uniform scale,
    a cylinder's end points and radius transformed);
    ``flip_normals``, ``id``."""
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
        raise NotImplementedError(_CURVES_NOT_PORTED)
    raise ValueError(f"unknown analytic shape type {t!r}")
