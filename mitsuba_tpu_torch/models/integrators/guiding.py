"""Guiding distributions for boundary (silhouette) sampling
(mitsuba_tpu/models/integrators/guiding.py; reference
src/python/python/ad/guiding.py).

``UniformDistr`` samples edges by their (detached) length.
``GridDistr`` learns a per-edge importance from a warm-up pass's
|boundary contribution| and resamples proportionally: for meshes the
boundary domain is the edge set, so the per-edge table is the grid.
The octree ``OcSpaceDistr`` guides only the shadow-boundary term, which
waits for ROADMAP.md Queue 1 item 5b.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ...core.distr import DiscreteDistribution


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

    ``update`` scatter-adds warm-up masses; ``finalize`` mixes them with
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
        return dataclasses.replace(
            self, mass=self.mass.index_add(0, idx, mass.to(self.mass.dtype)))

    def finalize(self, defensive: float = 0.1):
        total = torch.clamp(torch.sum(self.mass), min=1e-20)
        prior = self.lengths / torch.clamp(torch.sum(self.lengths), min=1e-20)
        p = (1.0 - defensive) * self.mass / total + defensive * prior
        return dataclasses.replace(self, distr=DiscreteDistribution.create(p))


class OcSpaceDistr:
    """The octree over the shadow term's sample cube (guiding.py:102-208
    of the JAX package): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "OcSpaceDistr guides the shadow-boundary term, which is not "
            "ported: ROADMAP.md Queue 1 item 5b")

    @staticmethod
    def create_from_samples(*args, **kwargs):
        return OcSpaceDistr()
