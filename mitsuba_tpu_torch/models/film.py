"""Film: reconstruction filters, pixel-grouped splatting, develop
(mitsuba_tpu/models/film.py; reference src/render/imageblock.cpp and
src/films/hdrfilm.cpp).

The image is an (H, W, C+1) buffer whose last channel accumulates the
filter weight, as in the reference's ImageBlock; ``develop`` divides it
out.  Only the scatter-free ``splat_grouped`` is ported: the main path's
lanes are pixel-major, so every filter tap is a static pixel offset.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class ReconstructionFilter:
    """Separable reconstruction filter: 'box' or 'gaussian' (the reference's
    default: truncated gaussian, stddev 0.5, radius 4 * stddev = 2)."""

    kind: str = "gaussian"
    radius: float = 2.0
    stddev: float = 0.5

    @staticmethod
    def box():
        return ReconstructionFilter(kind="box", radius=0.5)

    @staticmethod
    def gaussian(stddev: float = 0.5):
        return ReconstructionFilter(kind="gaussian", radius=4.0 * stddev,
                                    stddev=stddev)

    def eval_1d(self, x):
        """Filter value at (signed) offset x from the sample position."""
        ax = torch.abs(x)
        if self.kind == "box":
            return torch.where(ax <= self.radius, 1.0, 0.0)
        if self.kind == "gaussian":
            alpha = -1.0 / (2.0 * self.stddev ** 2)
            # the truncation constant is a float32 exp, as in the JAX package
            cut = torch.exp(torch.tensor(alpha * self.radius * self.radius,
                                         dtype=torch.float32, device=x.device))
            return torch.clamp(torch.exp(alpha * ax * ax) - cut, min=0.0)
        raise ValueError(f"unknown rfilter kind {self.kind!r}")


def splat_grouped(pos, values, height: int, width: int, spp: int,
                  rfilter: ReconstructionFilter, active=None):
    """Dense scatter-free splat for pixel-grouped wavefronts.

    Lanes must be pixel-major with exactly ``spp`` consecutive lanes per
    pixel and positions inside their own pixel (what ``sample_rays``
    produces).  Each tap offset (dx, dy) is then a per-pixel reduction
    over spp followed by a statically shifted add on a padded canvas.
    Returns (H, W, C+1) with the filter-weight channel last.
    """
    n, c = values.shape
    if n != height * width * spp:
        raise ValueError(f"{n} lanes are not pixel-major for a "
                         f"{width}x{height} film at {spp} spp")
    data = torch.cat([values, torch.ones_like(values[:, :1])], dim=-1)
    if active is not None:
        data = torch.where(active[:, None], data, 0.0)
    pos = torch.nan_to_num(pos, nan=0.0, posinf=0.0, neginf=0.0)
    rel = pos - torch.floor(pos)          # in-pixel offset in [0, 1)
    rx, ry = rel[:, 0], rel[:, 1]

    r = max(1, int(math.ceil(rfilter.radius)))
    canvas = torch.zeros((height + 2 * r, width + 2 * r, c + 1),
                         dtype=values.dtype, device=values.device)
    for dy in range(-r, r + 1):
        wy = rfilter.eval_1d(dy + 0.5 - ry)
        for dx in range(-r, r + 1):
            wx = rfilter.eval_1d(dx + 0.5 - rx)
            tap = ((wy * wx)[:, None] * data).reshape(
                height * width, spp, c + 1).sum(dim=1)
            canvas[r + dy:r + dy + height, r + dx:r + dx + width] += \
                tap.reshape(height, width, c + 1)
    return canvas[r:r + height, r:r + width]


def develop(image, eps: float = 1e-12):
    """Weight-division develop (hdrfilm.cpp:304): (H, W, C+1) -> (H, W, C)."""
    w = image[..., -1:]
    return torch.where(w > eps, image[..., :-1] / torch.clamp(w, min=eps), 0.0)


@dataclass
class Film:
    """hdrfilm equivalent: size and reconstruction filter."""

    width: int = 256
    height: int = 256
    rfilter: ReconstructionFilter = field(
        default_factory=ReconstructionFilter.gaussian)

    def put_grouped(self, pos, values, spp, active=None):
        return splat_grouped(pos, values, self.height, self.width, spp,
                             self.rfilter, active)

    def develop(self, image):
        return develop(image)
