"""Discrete 1D sampling distribution (mitsuba_tpu/core/distr.py;
reference include/mitsuba/core/distr_1d.h).

Backs emitter selection and the per-emitter face-area choice of area
lights.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .math import safe_div

ONE_MINUS_EPS = 1.0 - 2 ** -24


@dataclass
class DiscreteDistribution:
    pmf: torch.Tensor    # (N,) nonnegative weights
    cdf: torch.Tensor    # (N,) inclusive normalised CDF
    total: torch.Tensor  # () sum of the weights

    @staticmethod
    def create(pmf):
        pmf = pmf.to(torch.float32)
        total = torch.sum(pmf)
        return DiscreteDistribution(pmf=pmf, cdf=safe_div(torch.cumsum(pmf, 0),
                                                          total), total=total)

    @property
    def size(self) -> int:
        return int(self.pmf.shape[0])

    def eval_pmf_normalized(self, index):
        return safe_div(self.pmf[index], self.total)

    def sample(self, u):
        """u in [0, 1) -> index: a comparison-sum up to 128 entries, a
        binary search above, as in the JAX package."""
        if self.size <= 128:
            idx = (u[..., None] >= self.cdf[:-1]).to(torch.int64).sum(-1)
            return torch.clamp(idx, 0, self.size - 1)
        return torch.clamp(torch.searchsorted(self.cdf, u, right=True), 0,
                           self.size - 1)

    def sample_pmf(self, u):
        idx = self.sample(u)
        return idx, self.eval_pmf_normalized(idx)

    def sample_reuse_pmf(self, u):
        """An index, u rescaled to [0, 1) within its bin, and the pmf."""
        idx = self.sample(u)
        lo = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)], 0.0)
        pmf = self.eval_pmf_normalized(idx)
        u_re = torch.clamp(safe_div(u - lo, pmf), 0.0, ONE_MINUS_EPS)
        return idx, u_re, pmf
