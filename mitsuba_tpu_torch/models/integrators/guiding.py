"""Guiding distributions for boundary (silhouette) sampling
(mitsuba_tpu/models/integrators/guiding.py; reference
src/python/python/ad/guiding.py).

``UniformDistr`` samples edges by their (detached) length.
``GridDistr`` learns a per-edge importance from a warm-up pass's
|boundary contribution| and resamples proportionally: for meshes the
boundary domain is the edge set, so the per-edge table is the grid.
The octree ``OcSpaceDistr`` guides the shadow-boundary term over its
(u_edge, t, u_light) sample cube: the adaptive build runs on the host in
float64 numpy from a warm-up pass's points and masses, as in the JAX
package, so the leaf table comes out the same bit for bit; sampling and
the pdf run on the device over the leaf table.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ...core.distr import DiscreteDistribution
from ...ops.gather import index_add_rows


@dataclass
class UniformDistr:
    """Length-weighted uniform edge sampling."""

    distr: DiscreteDistribution

    @staticmethod
    def create(edge_lengths):
        return UniformDistr(
            distr=DiscreteDistribution.create(edge_lengths.detach()))

    def sample(self, u):
        """u (N,) -> (edge index, pmf)."""
        return self.distr.sample_pmf(u)

    def update(self, idx, mass):
        return self


@dataclass
class GridDistr:
    """Importance over edges learned from observed |contribution| mass.

    ``update`` scatter-adds warm-up masses (``index_add_rows``: the same
    bits from run to run on the GPU); ``finalize`` mixes them with
    the length prior (defensive sampling) so that unseen edges keep a
    nonzero probability."""

    distr: DiscreteDistribution
    lengths: torch.Tensor
    mass: torch.Tensor

    @staticmethod
    def create(edge_lengths):
        el = edge_lengths.detach()
        return GridDistr(distr=DiscreteDistribution.create(el), lengths=el,
                         mass=torch.zeros_like(el))

    def sample(self, u):
        return self.distr.sample_pmf(u)

    def update(self, idx, mass):
        return dataclasses.replace(self, mass=index_add_rows(
            self.mass, idx, mass.to(self.mass.dtype)))

    def finalize(self, defensive: float = 0.1):
        total = torch.clamp(torch.sum(self.mass), min=1e-20)
        prior = self.lengths / torch.clamp(torch.sum(self.lengths), min=1e-20)
        p = (1.0 - defensive) * self.mass / total + defensive * prior
        return dataclasses.replace(self, distr=DiscreteDistribution.create(p))


@dataclass
class OcSpaceDistr:
    """Octree-partitioned distribution over the boundary sample cube
    [0, 1]^3 (guiding.py:101-208 of the JAX package; reference
    guiding.py:141 OcSpaceDistr): a fixed leaf table (the boxes' corners
    and a ``DiscreteDistribution`` over the clamped leaf masses).  A draw
    picks a leaf by mass and places the point uniformly inside it; the
    pdf is pmf / volume."""

    leaf_min: torch.Tensor    # (L, 3)
    leaf_max: torch.Tensor    # (L, 3)
    distr: DiscreteDistribution
    n_leaves: int = 0

    @staticmethod
    def create_from_samples(points, masses, max_depth: int = 6,
                            max_leaf_count: int = 64,
                            clamp_input_mass_thres: float = 0.0,
                            clamp_mass_thres: float = 0.01,
                            prepartition_x_slices: int = 1,
                            defensive: float = 0.1):
        """The adaptive build (reference construct_octree semantics): a
        node holding more than ``max_leaf_count`` warm-up samples splits
        into its eight octants until ``max_depth``; a leaf's mass is the
        sum of its samples' |mass|, leaves under ``clamp_mass_thres`` of
        the largest are dropped, and the rest are mixed with the uniform
        volume prior (``defensive``) so that empty space keeps a nonzero
        density.  Reads the points and masses back to the host (one
        synchronisation); the table lives on the points' device."""
        device = points.device
        pts = np.clip(points.detach().cpu().numpy().astype(np.float64), 0.0,
                      1.0 - 1e-7)
        ms = masses.detach().cpu().numpy().astype(np.float64)
        ms = np.where(np.isfinite(ms), np.abs(ms), 0.0)
        if clamp_input_mass_thres > 0.0 and ms.size:
            hi = np.quantile(ms[ms > 0], 1.0 - clamp_input_mass_thres) \
                if (ms > 0).any() else 0.0
            ms = np.minimum(ms, hi) if hi > 0 else ms

        leaves = []   # (lo (3,), hi (3,), mass), in the JAX package's order
        stack = []
        nx = max(1, int(prepartition_x_slices))
        for sx in range(nx):
            lo = np.array([sx / nx, 0.0, 0.0])
            hi = np.array([(sx + 1) / nx, 1.0, 1.0])
            inside = np.nonzero((pts[:, 0] >= lo[0]) & (pts[:, 0] < hi[0]))[0]
            stack.append((lo, hi, inside, 0))
        while stack:
            lo, hi, idx, depth = stack.pop()
            if len(idx) <= max_leaf_count or depth >= max_depth:
                leaves.append((lo, hi, float(ms[idx].sum())))
                continue
            mid = 0.5 * (lo + hi)
            p = pts[idx]
            oct_id = ((p[:, 0] >= mid[0]).astype(np.int32)
                      + 2 * (p[:, 1] >= mid[1]).astype(np.int32)
                      + 4 * (p[:, 2] >= mid[2]).astype(np.int32))
            for k in range(8):
                upper = [k & 1, k & 2, k & 4]
                stack.append((np.where(upper, mid, lo).astype(np.float64),
                              np.where(upper, hi, mid).astype(np.float64),
                              idx[oct_id == k], depth + 1))

        lo = np.stack([leaf[0] for leaf in leaves])
        hi = np.stack([leaf[1] for leaf in leaves])
        mass = np.asarray([leaf[2] for leaf in leaves])
        vol = np.prod(hi - lo, axis=1)
        mass = mass / max(mass.sum(), 1e-20)
        mass = np.where(mass < clamp_mass_thres * mass.max(initial=0.0), 0.0,
                        mass)
        mass = (1.0 - defensive) * mass / max(mass.sum(), 1e-20) \
            + defensive * vol / vol.sum()

        def f32(a):
            return torch.as_tensor(a.astype(np.float32), device=device)

        return OcSpaceDistr(leaf_min=f32(lo), leaf_max=f32(hi),
                            distr=DiscreteDistribution.create(f32(mass)),
                            n_leaves=len(leaves))

    def _volumes(self, lo, hi):
        e = torch.clamp(hi - lo, min=1e-12)
        return e[..., 0] * e[..., 1] * e[..., 2]

    def sample(self, u1, u3):
        """u1 (N,), u3 (N, 3) -> (point (N, 3) in [0, 1]^3, pdf (N,) per
        unit volume)."""
        idx, pmf = self.distr.sample_pmf(u1)
        lo, hi = self.leaf_min[idx], self.leaf_max[idx]
        return lo + u3 * (hi - lo), pmf / self._volumes(lo, hi)

    def pdf(self, p):
        """The density at points p (N, 3): a containment-masked sum over
        the leaf table."""
        inside = ((p[:, None, :] >= self.leaf_min[None])
                  & (p[:, None, :] < self.leaf_max[None])).all(dim=-1)
        pmf = self.distr.eval_pmf_normalized(
            torch.arange(self.leaf_min.shape[0], device=p.device))
        dens = pmf / self._volumes(self.leaf_min, self.leaf_max)
        return torch.sum(torch.where(inside, dens[None, :], 0.0), dim=-1)
