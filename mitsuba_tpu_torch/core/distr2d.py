"""Piecewise-constant 2D distribution (mitsuba_tpu/core/distr2d.py
``Marginal2D``; reference include/mitsuba/core/distr_2d.h).

The marginal-conditional form: a row marginal CDF and a conditional CDF
per row, sampled with two inverse-CDF lookups.  It backs the
environment map's luminance importance sampling.

The JAX package finds a lane's column by comparing u with its whole
gathered CDF row, an (N, W) block: 34 GB at 4,194,304 lanes of a
2048-column map.  Here each index is the same count, the entries of the
row below u, from ``torch.searchsorted`` (left) over the flattened
conditional CDF in float64, each row offset by twice its index: every
float32 value and every offset is exact in float64, and the rows' ranges
(at most [0, 1 + eps]) stay apart, so the count within the row is the
JAX package's.  The CDFs are cumulative sums in float64 rounded to
float32, so they never decrease, which the search needs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .math import safe_div

# the largest u_frac (1 - 1e-7 in float32), as in the JAX package
FRAC_MAX = 1.0 - 1e-7


@dataclass
class Marginal2D:
    """Over [0, 1]^2: ``pdf_table`` (H, W) holds the unnormalised cell
    weights; ``sample`` returns continuous (u, v) with density ``pdf``
    per unit area."""

    pdf_table: torch.Tensor   # (H, W) nonnegative
    row_cdf: torch.Tensor     # (H,) inclusive, normalised
    cond_cdf: torch.Tensor    # (H, W) inclusive, normalised per row
    row_weight: torch.Tensor  # (H,) row sums
    total: torch.Tensor       # () sum of the weights
    _flat: torch.Tensor | None = field(default=None, repr=False)

    @staticmethod
    def create(table):
        """From an (H, W) table of nonnegative weights, on its device."""
        table = torch.as_tensor(table, dtype=torch.float32)
        t64 = table.double()
        row_w = t64.sum(dim=1)
        total = row_w.sum()
        row_cdf = safe_div(torch.cumsum(row_w, 0), total)
        cond = safe_div(torch.cumsum(t64, 1), row_w[:, None])
        return Marginal2D(pdf_table=table, row_cdf=row_cdf.float(),
                          cond_cdf=cond.float(), row_weight=row_w.float(),
                          total=total.float())

    @property
    def shape(self):
        return tuple(self.pdf_table.shape)

    def _offset_rows(self):
        """The conditional CDF flattened in float64, row r offset by 2r."""
        if self._flat is None:
            h, w = self.shape
            rows = torch.arange(h, dtype=torch.float64,
                                device=self.cond_cdf.device)
            self._flat = (self.cond_cdf.double()
                          + 2.0 * rows[:, None]).reshape(-1)
        return self._flat

    def sample_cells(self, sample2):
        """The (row, column) cell of each lane's (N, 2) uniforms: the
        entries of the marginal below u[1], and of the row's conditional
        below u[0], clipped to the table."""
        h, w = self.shape
        u0, u1 = sample2[..., 0], sample2[..., 1]
        row = torch.searchsorted(self.row_cdf, u1.contiguous())
        row = torch.clamp(row, 0, h - 1)
        q = u0.double() + 2.0 * row.double()
        col = torch.searchsorted(self._offset_rows(), q.contiguous()) - row * w
        return row, torch.clamp(col, 0, w - 1)

    def sample(self, sample2):
        """(N, 2) uniforms -> ((N, 2) uv, (N,) pdf per unit area)."""
        h, w = self.shape
        u0, u1 = sample2[..., 0], sample2[..., 1]
        row, col = self.sample_cells(sample2)
        lo_r = torch.where(row > 0, self.row_cdf[torch.clamp(row - 1, min=0)],
                           0.0)
        pr = safe_div(self.row_weight[row], self.total)
        v_frac = torch.clamp(safe_div(u1 - lo_r, pr), 0.0, FRAC_MAX)
        v = (row.to(torch.float32) + v_frac) / h
        lo_c = torch.where(col > 0,
                           self.cond_cdf[row, torch.clamp(col - 1, min=0)],
                           0.0)
        pc = safe_div(self.pdf_table[row, col], self.row_weight[row])
        u_frac = torch.clamp(safe_div(u0 - lo_c, pc), 0.0, FRAC_MAX)
        u = (col.to(torch.float32) + u_frac) / w
        uv = torch.stack([u, v], dim=-1)
        return uv, self.pdf(uv)

    def pdf(self, uv):
        """Density at ``uv`` per unit area of [0, 1]^2."""
        h, w = self.shape
        col = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        row = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        return safe_div(self.pdf_table[row, col] * (h * w), self.total)
