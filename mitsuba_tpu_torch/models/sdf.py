"""The differentiable SDF-grid shape (mitsuba_tpu/models/sdf.py;
reference src/shapes/sdfgrid.cpp).

A signed distance sampled on a dense (D, H, W) grid of nodes spanning
[bbox_min, bbox_max], z-major, read by trilinear interpolation:

- ``ray_intersect`` sphere-traces the detached ray: ``N_MARCH`` fixed
  iterations, each a masked step of ``SAFETY`` times phi (at least the
  tolerance, 2e-5 of the box's extent, well below the spawn offset),
  then one secant step between the last point of positive phi and the
  crossing; no host sync inside;
- ``grad`` is the closed-form gradient of the trilinear interpolant
  (the JAX package takes it from ``jax.grad`` of ``eval``: the same
  values to rounding);
- ``attach_point`` is the implicit-function motion of a detached hit
  x*: p = x* - phi(x*) d / (grad phi . d), equal to x* in value, whose
  derivative with respect to the grid values slides the point along
  the ray with the level set; grazing hits clamp |grad phi . d| to
  0.05 |grad phi|.

The scene holds at most one SDF (``Scene.scene_sdf``), in the shape
slot after the meshes; its query is merged into the preliminary hit by
closest t (models/scene.py).  The eight corner values of a lane are
gathered by ``ops/gather.py::gather_rows``, whose backward repeats bit
for bit on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.math import dot, normalize, sqrt
from ..ops.gather import gather_rows

N_MARCH = 96
SAFETY = 0.9


@dataclass
class SDFGrid:
    """``values`` (D, H, W) signed distances in world units, z-major,
    over [bbox_min, bbox_max] (a differentiable leaf)."""

    values: torch.Tensor    # (D, H, W)
    bbox_min: torch.Tensor  # (3,)
    bbox_max: torch.Tensor  # (3,)
    bsdf_index: int = 0
    id: str = "sdfgrid"

    # ------------------------------------------------------------- eval

    def _cell(self, p):
        """(flat index of the cell's first node (..., ), fractions (..., 3)
        in (z, y, x)): world -> node coordinates, nodes at integers."""
        d, h, w = self.values.shape
        u = (p - self.bbox_min) / (self.bbox_max - self.bbox_min)
        g = torch.stack([u[..., 2] * (d - 1), u[..., 1] * (h - 1),
                         u[..., 0] * (w - 1)], dim=-1)
        hi = torch.tensor([d - 2, h - 2, w - 2], device=p.device)
        i0 = torch.minimum(torch.clamp(torch.floor(g).long(), min=0), hi)
        f = torch.clamp(g - i0, 0.0, 1.0)
        return i0, f

    def _corners(self, i0):
        """The eight corner values of each lane's cell, (..., 8), in the
        order (dz, dy, dx) of ``eval``'s sum."""
        _, h, w = self.values.shape
        base = (i0[..., 0] * h + i0[..., 1]) * w + i0[..., 2]
        offs = torch.tensor([dz * h * w + dy * w + dx for dz in (0, 1)
                             for dy in (0, 1) for dx in (0, 1)],
                            device=i0.device)
        idx = (base[..., None] + offs).reshape(-1)
        vals = gather_rows(self.values.reshape(-1), idx)
        return vals.reshape(base.shape + (8,))

    def eval(self, p):
        """Trilinear phi(p), clamped to the grid outside it."""
        i0, f = self._cell(p)
        v = self._corners(i0)
        out = 0.0
        k = 0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    wgt = ((f[..., 0] if dz else 1 - f[..., 0])
                           * (f[..., 1] if dy else 1 - f[..., 1])
                           * (f[..., 2] if dx else 1 - f[..., 2]))
                    out = out + wgt * v[..., k]
                    k += 1
        return out

    def grad(self, p):
        """d phi / d p in world units: the trilinear interpolant's
        gradient, 0 along an axis where p lies outside the grid (where
        ``eval`` clamps)."""
        d, h, w = self.values.shape
        i0, f = self._cell(p)
        v = self._corners(i0)
        fz, fy, fx = f[..., 0], f[..., 1], f[..., 2]
        gz = gy = gx = 0.0
        k = 0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    wz = fz if dz else 1 - fz
                    wy = fy if dy else 1 - fy
                    wx = fx if dx else 1 - fx
                    sz, sy, sx = (1.0 if dz else -1.0, 1.0 if dy else -1.0,
                                  1.0 if dx else -1.0)
                    gz = gz + sz * wy * wx * v[..., k]
                    gy = gy + wz * sy * wx * v[..., k]
                    gx = gx + wz * wy * sx * v[..., k]
                    k += 1
        # d f / d p: the node coordinates' scale, 0 where the fraction
        # is clamped (outside the grid)
        u = (p - self.bbox_min) / (self.bbox_max - self.bbox_min)
        g = torch.stack([u[..., 2] * (d - 1), u[..., 1] * (h - 1),
                         u[..., 0] * (w - 1)], dim=-1)
        r = g - i0
        inside = (r > 0.0) & (r < 1.0)
        ext = self.bbox_max - self.bbox_min
        scale = torch.stack([(d - 1) / ext[2], (h - 1) / ext[1],
                             (w - 1) / ext[0]])
        dz_ = torch.where(inside[..., 0], gz * scale[0], 0.0)
        dy_ = torch.where(inside[..., 1], gy * scale[1], 0.0)
        dx_ = torch.where(inside[..., 2], gx * scale[2], 0.0)
        return torch.stack([dx_, dy_, dz_], dim=-1)

    def normal(self, p):
        return normalize(self.grad(p))

    # -------------------------------------------------------- intersect

    def _ray_bbox(self, o, d):
        inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
        t0 = (self.bbox_min - o) * inv
        t1 = (self.bbox_max - o) * inv
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        return tmin, tmax

    def ray_intersect(self, o, d, maxt, active):
        """Sphere trace of the detached rays: (t, hit), t the secant-
        refined crossing in [0, maxt] (inf on a miss), hit within the
        box and ``active``."""
        with torch.no_grad():
            return self._trace(o.detach(), d.detach(), maxt.detach(), active)

    def _trace(self, o, d, maxt, active):
        tmin, tmax = self._ray_bbox(o, d)
        tmax = torch.minimum(tmax, maxt)
        enter = torch.clamp(tmin, min=1e-4)
        valid0 = active & (tmax > enter)
        tol = 2e-5 * torch.amax(self.bbox_max - self.bbox_min)
        n = o.shape[0]
        t, done = enter, ~valid0
        hit = torch.zeros(n, dtype=torch.bool, device=o.device)
        prev_phi = torch.full((n,), 1e8, device=o.device)
        prev_t = enter
        for _ in range(N_MARCH):
            phi = self.eval(o + d * t[:, None])
            crossed = (phi < tol) & ~done
            hit = hit | (crossed & (t <= tmax))
            step = torch.maximum(SAFETY * phi, tol)
            nt = t + torch.where(done | crossed, 0.0, step)
            done = done | crossed | (nt > tmax)
            prev_phi = torch.where(crossed, prev_phi, phi)
            prev_t = torch.where(crossed, prev_t, t)
            t = nt
        # the secant step between the last point of positive phi and t
        phi_t = self.eval(o + d * t[:, None])
        denom = prev_phi - phi_t
        big = torch.abs(denom) > 1e-12
        frac = torch.where(big, prev_phi / torch.where(big, denom, 1.0), 0.0)
        t_ref = prev_t + torch.clamp(frac, 0.0, 1.0) * (t - prev_t)
        return torch.where(hit, t_ref, torch.inf), hit & valid0

    # ------------------------------------------------------- surface it

    def attach_point(self, x_det, d):
        """The differentiable hit position: x_det in value, its
        derivative with respect to ``values`` the ray's slide along the
        moving level set (dt = -dphi / (grad phi . d)); grazing hits
        clamped."""
        x_det = x_det.detach()
        phi = self.eval(x_det)
        g = self.grad(x_det).detach()
        denom = dot(g, d, keepdim=True)
        gn = sqrt(torch.clamp(dot(g, g, keepdim=True), min=1e-12))
        denom = torch.where(torch.abs(denom) > 0.05 * gn, denom,
                            torch.sign(denom) * 0.05 * gn)
        return x_det - phi[:, None] * d / denom


def sphere_sdf_grid(radius=0.7, center=(0.0, 0.0, 0.0), res=32, extent=1.0,
                    bsdf_index=0, device=None):
    """The SDF of a sphere sampled on a res^3 grid over [-extent,
    extent]^3 (the JAX package's helper), on ``device`` (default: the
    GPU)."""
    from ..device import resolve_device

    device = resolve_device(device)
    lin = np.linspace(-extent, extent, res, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    c = np.asarray(center, np.float32)
    vals = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                   + (z - c[2]) ** 2) - radius
    box = torch.tensor([extent] * 3, dtype=torch.float32, device=device)
    return SDFGrid(values=torch.tensor(vals, device=device), bbox_min=-box,
                   bbox_max=box, bsdf_index=bsdf_index)
