"""Film: reconstruction filters, splatting, develop
(mitsuba_tpu/models/film.py; reference src/render/imageblock.cpp and
src/films/hdrfilm.cpp).

The image is an (H, W, C+1) buffer whose last channel accumulates the
filter weight, as in the reference's ImageBlock; ``develop`` divides it
out.  Two splats: the scatter-free ``splat_grouped`` of the camera paths,
whose lanes are pixel-major so that every filter tap is a static pixel
offset, and ``splat`` at any film position, a scatter-add of each
sample's K x K taps normalised to sum 1, which the particle tracer calls:
``ops/gather.py::index_add_rows``, ``index_add`` on the CPU and a
fixed-point sum on the GPU, so that a splat repeats bit for bit there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..core.math import via_f64
from ..ops.gather import index_add_rows


@dataclass(frozen=True)
class ReconstructionFilter:
    """Separable reconstruction filter: 'box', 'tent', 'gaussian' (the
    reference's default: truncated gaussian, stddev 0.5, radius 4 * stddev
    = 2), 'mitchell' (Mitchell-Netravali, radius 2; Catmull-Rom is its B =
    0, C = 1/2) or 'lanczos' (a windowed sinc of ``lobes`` lobes, radius
    ``lobes``).  Both splats take any of them: each sample touches
    2 ceil(radius) + 1 pixels an axis in ``splat_grouped``,
    ``n_taps`` in ``splat``."""

    kind: str = "gaussian"
    radius: float = 2.0
    stddev: float = 0.5
    b: float = 1.0 / 3.0     # mitchell B
    c: float = 1.0 / 3.0     # mitchell C
    lobes: int = 3           # lanczos tau

    @staticmethod
    def box():
        return ReconstructionFilter(kind="box", radius=0.5)

    @staticmethod
    def tent():
        return ReconstructionFilter(kind="tent", radius=1.0)

    @property
    def n_taps(self) -> int:
        """Taps a sample touches along each axis in ``splat``."""
        return max(1, int(math.ceil(2.0 * self.radius)))

    @staticmethod
    def gaussian(stddev: float = 0.5):
        return ReconstructionFilter(kind="gaussian", radius=4.0 * stddev,
                                    stddev=stddev)

    @staticmethod
    def mitchell(b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
        """Mitchell-Netravali (src/rfilters/mitchell.cpp)."""
        return ReconstructionFilter(kind="mitchell", radius=2.0, b=b, c=c)

    @staticmethod
    def catmullrom():
        """Catmull-Rom: Mitchell with B = 0, C = 1/2 (catmullrom.cpp)."""
        return ReconstructionFilter(kind="mitchell", radius=2.0, b=0.0, c=0.5)

    @staticmethod
    def lanczos(lobes: int = 3):
        """Lanczos-windowed sinc (src/rfilters/lanczos.cpp)."""
        return ReconstructionFilter(kind="lanczos", radius=float(lobes),
                                    lobes=lobes)

    def eval_1d(self, x):
        """Filter value at (signed) offset x from the sample position."""
        ax = torch.abs(x)
        if self.kind == "box":
            return torch.where(ax <= self.radius, 1.0, 0.0)
        if self.kind == "tent":
            return torch.clamp(1.0 - ax / self.radius, min=0.0)
        if self.kind == "gaussian":
            alpha = -1.0 / (2.0 * self.stddev ** 2)
            # the truncation constant is a float32 exp, as in the JAX package
            cut = torch.exp(torch.tensor(alpha * self.radius * self.radius,
                                         dtype=torch.float32, device=x.device))
            return torch.clamp(torch.exp(alpha * ax * ax) - cut, min=0.0)
        if self.kind == "mitchell":
            b, c = self.b, self.c
            x2 = ax * ax
            x3 = x2 * ax
            inner = ((12.0 - 9.0 * b - 6.0 * c) * x3
                     + (-18.0 + 12.0 * b + 6.0 * c) * x2
                     + (6.0 - 2.0 * b)) * (1.0 / 6.0)
            outer = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
                     + (-12.0 * b - 48.0 * c) * ax
                     + (8.0 * b + 24.0 * c)) * (1.0 / 6.0)
            return torch.where(ax < 1.0, inner,
                               torch.where(ax < 2.0, outer, 0.0))
        if self.kind == "lanczos":
            t = self.lobes

            def sinc(y):   # y >= 0
                return torch.where(
                    y < 1e-6, 1.0,
                    via_f64(torch.sin, math.pi * y)
                    / torch.clamp(math.pi * y, min=1e-12))

            return torch.where(ax < t, sinc(ax) * sinc(ax / t), 0.0)
        raise ValueError(f"unknown rfilter kind {self.kind!r}")


def splat(pos, values, height: int, width: int, rfilter: ReconstructionFilter,
          active=None):
    """Splat (N, C) ``values`` at film positions ``pos`` (N, 2) in pixels
    (x in [0, W), y in [0, H), pixel centres at i + 0.5) through the
    filter's K x K taps, each sample's tap weights divided by their sum;
    returns (H, W, C+1) with the filter-weight channel last (imageblock.cpp
    put in its normalize mode, that of the particle tracer, whose develop
    does not divide by the weight channel; film.py:124 of the JAX package
    with ``normalize=True``).  Differentiable with respect to ``values``
    and ``pos``."""
    n, c = values.shape
    dev = values.device
    sample_w = torch.ones((n, 1), dtype=values.dtype, device=dev)
    if active is not None:
        values = torch.where(active[:, None], values, 0.0)
        sample_w = torch.where(active[:, None], sample_w, 0.0)
    # a lane left inactive may carry a NaN or infinite position
    bound = float(max(width, height)) + rfilter.radius + 2.0
    pos = torch.clamp(torch.nan_to_num(pos, nan=-bound, posinf=bound,
                                       neginf=-bound), -bound, bound)
    k = rfilter.n_taps
    lo = torch.ceil(pos.detach() - rfilter.radius - 0.5).to(torch.int64)
    offs = torch.arange(k, device=dev)
    xs = lo[:, 0:1] + offs
    ys = lo[:, 1:2] + offs
    wx = rfilter.eval_1d(xs.to(pos.dtype) + 0.5 - pos[:, 0:1])
    wy = rfilter.eval_1d(ys.to(pos.dtype) + 0.5 - pos[:, 1:2])
    wx = torch.where((xs >= 0) & (xs < width), wx, 0.0)
    wy = torch.where((ys >= 0) & (ys < height), wy, 0.0)
    w = wy[:, :, None] * wx[:, None, :]
    if active is not None:
        w = w * active[:, None, None]
    w = w / torch.clamp(w.sum(dim=(1, 2), keepdim=True), min=1e-12)
    idx = (ys.clamp(0, height - 1)[:, :, None] * width
           + xs.clamp(0, width - 1)[:, None, :]).reshape(n * k * k)
    data = torch.cat([values, sample_w], dim=-1)
    contrib = (w[..., None] * data[:, None, None, :]).reshape(n * k * k,
                                                              c + 1)
    img = torch.zeros((height * width, c + 1), dtype=values.dtype, device=dev)
    return index_add_rows(img, idx, contrib).reshape(height, width, c + 1)


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

    def put(self, pos, values, active=None):
        return splat(pos, values, self.height, self.width, self.rfilter,
                     active)

    def put_grouped(self, pos, values, spp, active=None):
        return splat_grouped(pos, values, self.height, self.width, spp,
                             self.rfilter, active)

    def develop(self, image):
        return develop(image)
