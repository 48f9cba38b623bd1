"""Lens interface elements: spherical, planar, aperture stop, aspherical
(mitsuba_tpu/lens/elements.py; reference src/sensors/realisticlens.cpp:
245-818).

Each element's geometry (curvature, z position, asphere coefficients)
and glasses are differentiable leaves; ``compute_interaction(ray,
active)`` refracts a batch of rays at the surface and returns (the
advanced ray, valid).  A lane that misses, leaves the element's radius
or is totally reflected is not valid; its advanced ray is garbage that
the camera never keeps (``RealisticLensCamera`` parks such lanes), but
it stays finite, so that no NaN reaches a gradient through the
``where`` that drops it.

The asphere's intersection runs ``newton_iters`` tangent-plane steps on
a detached iterate (no graph), then one attached step from the converged
point: its gradient is the implicit function's (realisticlens.cpp:
574-645 caps the reference's loop at 10 steps).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..core.fresnel import fresnel_dielectric, refract_n
from ..core.math import dot, normalize, sqr
from ..core.records import Ray
from .materials import DispersiveMaterial

INF = math.inf


def _fresnel_refract_global(ray_d, n, eta_rel):
    """Dielectric Fresnel and refraction in the camera frame
    (LensInterface::compute_interaction, realisticlens.cpp:286-292).

    ``n`` faces the incident side by construction; ``eta_rel`` = int_ior
    / ext_ior.  Returns (reflectance, refracted direction, valid)."""
    cos_i = dot(-ray_d, n)
    r, cos_t, _, eta_ti = fresnel_dielectric(cos_i, eta_rel)
    d_out = normalize(refract_n(-ray_d, n, cos_t, eta_ti))
    return r, d_out, r <= (1.0 - 1e-6)


def _advance(ray: Ray, t, p, d):
    return Ray(o=p, d=d, maxt=torch.full_like(t, INF),
               wavelengths=ray.wavelengths)


def _axis_point(z):
    """(0, 0, z) of a scalar tensor."""
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z])


def _inside_radius(p, element_radius):
    return (sqr(p[..., 0]) + sqr(p[..., 1])) < sqr(element_radius)


def _refract(elem, ray, t, p, n, valid, active):
    """The shared tail of the refracting elements' ``compute_interaction``."""
    valid = valid & active & _inside_radius(p, elem.element_radius)
    ext_ior = elem.left.ior_from_ray(ray)
    int_ior = elem.right.ior_from_ray(ray)
    _, d_out, refr_ok = _fresnel_refract_global(ray.d, n, int_ior / ext_ior)
    return _advance(ray, t, p, d_out), valid & refr_ok


def _at(ray, t):
    """The points at t along the rays, with t = 0 where t is not finite:
    a miss's point is never used, and an infinite one would give NaN
    gradients through the normal."""
    t = torch.where(torch.isfinite(t), t, 0.0)
    return ray.o + ray.d * t[..., None]


@dataclass
class SpheroidLens:
    """Spherical refracting surface (realisticlens.cpp:346)."""

    curvature_radius: torch.Tensor  # () signed: convex (+), concave (-)
    element_radius: torch.Tensor    # ()
    z_intercept: torch.Tensor       # ()
    left: DispersiveMaterial        # the world side's glass
    right: DispersiveMaterial       # the film side's glass
    kind: str = "sphere"

    def center(self):
        return self.z_intercept + self.curvature_radius

    def intersect(self, ray: Ray):
        """(t, p, n, valid), the root chosen by convexity."""
        c = _axis_point(self.center())
        p_local = c - ray.o
        center_proj = dot(p_local, ray.d)
        perp2 = dot(p_local, p_local) - sqr(center_proj)
        disc = sqr(self.curvature_radius) - perp2
        valid = disc >= 0.0
        sqrt_disc = torch.sqrt(torch.where(valid, disc, 1.0)) * valid
        near_t = center_proj - sqrt_disc
        far_t = center_proj + sqrt_disc
        valid = valid & (far_t >= 0.0)
        is_convex = self.curvature_radius > 0.0
        pick_near = is_convex ^ (ray.d[..., 2] < 0.0)
        t = torch.where(pick_near,
                        torch.where(near_t >= 0.0, near_t, INF), far_t)
        valid = valid & torch.isfinite(t)
        p = _at(ray, t)
        n = normalize(p - c)
        n = torch.where(is_convex, n, -n)
        return t, p, n, valid

    def compute_interaction(self, ray: Ray, active):
        t, p, n, valid = self.intersect(ray)
        return _refract(self, ray, t, p, n, valid, active)


def _plane_intersect(elem, ray: Ray):
    """The plane z = z_intercept, normal (0, 0, -1)."""
    n_dot_d = -ray.d[..., 2]
    ok = torch.abs(n_dot_d) >= 1e-8
    t = (-elem.z_intercept + ray.o[..., 2]) / torch.where(ok, n_dot_d, 1.0)
    valid = ok & (t >= 0.0)
    p = ray.o + ray.d * t[..., None]
    n = torch.tensor([0.0, 0.0, -1.0], device=p.device).expand(p.shape)
    return t, p, n, valid


@dataclass
class PlanoLens:
    """Planar refracting surface, normal (0, 0, -1) (realisticlens.cpp:428)."""

    element_radius: torch.Tensor
    z_intercept: torch.Tensor
    left: DispersiveMaterial
    right: DispersiveMaterial
    kind: str = "plane"

    def intersect(self, ray: Ray):
        return _plane_intersect(self, ray)

    def compute_interaction(self, ray: Ray, active):
        t, p, n, valid = self.intersect(ray)
        return _refract(self, ray, t, p, n, valid, active)


@dataclass
class ApertureStop:
    """Pass-through stop: kills the rays outside its radius
    (realisticlens.cpp:496)."""

    element_radius: torch.Tensor
    z_intercept: torch.Tensor
    left: DispersiveMaterial
    right: DispersiveMaterial
    kind: str = "aperture"

    def intersect(self, ray: Ray):
        return _plane_intersect(self, ray)

    def compute_interaction(self, ray: Ray, active):
        t, p, _, valid = self.intersect(ray)
        valid = valid & active & _inside_radius(p, self.element_radius)
        return _advance(ray, t, p, ray.d), valid


@dataclass
class AsphericalLens:
    """Conic plus even-asphere surface (realisticlens.cpp:554).

    Sag, dimensionless, of r2_ = (r / R_elem)^2 (realisticlens.cpp:680-707):
    z_(r2_) = c_ r2_ / (1 + sqrt(1 - (1 + K) c_^2 r2_)) + sum ai_[i]
    r2_^(i+2), and z(r) = -z_ R_elem + z_intercept, with c_ = R_elem /
    curvature_radius and the ai prescaled by powers of R_elem at build
    time (realisticlens.cpp:560-572)."""

    c_unitless: torch.Tensor      # () R_elem / curvature_radius
    kappa: torch.Tensor           # () conic constant
    ai: torch.Tensor              # (A,) prescaled asphere coefficients
    element_radius: torch.Tensor  # () metres
    z_intercept: torch.Tensor     # ()
    left: DispersiveMaterial
    right: DispersiveMaterial
    newton_iters: int = 10
    kind: str = "asphere"

    def _sag_unitless(self, r2_):
        sqr_term = 1.0 - (1.0 + self.kappa) * sqr(self.c_unitless) * r2_
        z_ = self.c_unitless * r2_ / (
            1.0 + torch.sqrt(torch.clamp(sqr_term, min=1e-12)))
        poly = torch.zeros_like(r2_)
        for i in range(self.ai.shape[0] - 1, -1, -1):
            poly = poly * r2_ + self.ai[i]
        return z_ + poly * sqr(r2_)

    def sag_z(self, r2):
        """The surface's z at radius^2 ``r2`` (metres)."""
        r2_ = r2 / sqr(self.element_radius)
        return (-self._sag_unitless(r2_) * self.element_radius
                + self.z_intercept)

    def _sag_grad_unitless(self, r2_):
        """d z_ / d r_ (realisticlens.cpp _eval_asph_grad)."""
        r_ = torch.sqrt(torch.clamp(r2_, min=1e-20))
        cr = self.c_unitless * r_
        sqr_term = 1.0 - (1.0 + self.kappa) * sqr(cr)
        dz = cr / torch.sqrt(torch.clamp(sqr_term, min=1e-12))
        poly = torch.zeros_like(r2_)
        for i in range(self.ai.shape[0] - 1, -1, -1):
            poly = poly * r2_ + (2.0 * i + 4.0) * self.ai[i]
        return dz + poly * r2_ * r_

    def normal(self, p):
        """The surface normal at p (realisticlens.cpp:647-657)."""
        radial = p[..., :2] / self.element_radius
        r2_ = dot(radial, radial)
        safe = r2_ >= 4e-7
        inv_r = torch.where(
            safe, 1.0 / torch.sqrt(torch.clamp(r2_, min=1e-20)), 0.0)
        radial = radial * inv_r[..., None]
        zg = self._sag_grad_unitless(r2_)
        n = torch.stack([zg * radial[..., 0], zg * radial[..., 1],
                         -torch.ones_like(zg)], dim=-1)
        return normalize(n)

    def _intersect_conic(self, ray: Ray):
        """The first guess: the pure conic's hit (realisticlens.cpp:762)."""
        R = self.element_radius
        o = (ray.o - _axis_point(self.z_intercept)) / R
        d = ray.d
        c = self.c_unitless
        K = self.kappa
        A = c * (1.0 + K * sqr(d[..., 2]))
        B = 2.0 * (c * (dot(o, d) + K * o[..., 2] * d[..., 2]) - d[..., 2])
        C = c * (dot(o, o) + K * sqr(o[..., 2])) - 2.0 * o[..., 2]
        # A t^2 + B t + C = 0, linear where A ~ 0
        lin = torch.abs(A) < 1e-12
        disc = B * B - 4.0 * A * C
        pos = disc >= 0.0
        valid = lin | pos
        sq = torch.sqrt(torch.where(pos, disc, 1.0)) * pos
        q = -0.5 * (B + torch.sign(B) * sq)
        t0q = q / torch.where(torch.abs(A) > 1e-20, A, 1.0)
        t1q = C / torch.where(torch.abs(q) > 1e-20, q, 1.0)
        t_lin = -C / torch.where(torch.abs(B) > 1e-20, B, 1.0)
        t0 = torch.where(lin, t_lin, torch.minimum(t0q, t1q)) * R
        t1 = torch.where(lin, t_lin, torch.maximum(t0q, t1q)) * R
        # the root must lie on the real branch (realisticlens.cpp:783)
        zmax = torch.where(K > -1.0, R / (1.0 + K), INF)
        zt0 = c * (ray.o[..., 2] + t0 * d[..., 2] - self.z_intercept)
        zt1 = c * (ray.o[..., 2] + t1 * d[..., 2] - self.z_intercept)
        v0 = valid & (zt0 > 0.0) & (zt0 <= zmax)
        v1 = valid & (zt1 > 0.0) & (zt1 <= zmax)
        both = v0 & v1
        t = torch.where(both, torch.where(t0 > 0.0, t0, t1),
                        torch.where(v0, t0, t1))
        return t, valid & (v0 | v1)

    def _newton_step(self, ray, t):
        """One tangent-plane step from the point at t: (t_new, |z error|)."""
        p = ray.o + ray.d * t[..., None]
        r2 = sqr(p[..., 0]) + sqr(p[..., 1])
        z_surf = self.sag_z(r2)
        err = torch.abs(p[..., 2] - z_surf)
        plane_p = torch.stack([p[..., 0], p[..., 1], z_surf], dim=-1)
        plane_n = self.normal(p)
        denom = dot(plane_n, ray.d)
        t_new = dot(plane_n, plane_p - ray.o) / torch.where(
            torch.abs(denom) > 1e-12, denom, 1.0)
        return t_new, err

    def intersect(self, ray: Ray):
        t0, conic_ok = self._intersect_conic(ray)
        dz = ray.d[..., 2]
        t_plane = (self.z_intercept - ray.o[..., 2]) / torch.where(
            torch.abs(dz) > 1e-12, dz, 1.0)
        t = torch.where(conic_ok, t0, t_plane)
        with torch.no_grad():
            t = t.detach()
            for _ in range(self.newton_iters):
                t, _ = self._newton_step(ray, t)
        t, err = self._newton_step(ray, t)
        valid = (err < 1e-5) & (t > 0.0)
        p = _at(ray, t)
        return t, p, self.normal(p), valid

    def compute_interaction(self, ray: Ray, active):
        t, p, n, valid = self.intersect(ray)
        return _refract(self, ray, t, p, n, valid, active)


def offset_element(elem, delta):
    """The element shifted along the optical axis by ``delta``
    (offset_along_axis, realisticlens.cpp:265)."""
    return dataclasses.replace(elem, z_intercept=elem.z_intercept + delta)
