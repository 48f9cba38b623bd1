"""Textures (mitsuba_tpu/models/textures.py): the constant texture and the
bitmap texture at its base level."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ConstantTexture:
    value: torch.Tensor   # (C,), typically (3,) RGB

    def eval(self, si):
        """The value for each lane of ``si`` (any record with ``uv``)."""
        return self.value.expand(si.uv.shape[0], *self.value.shape)


@dataclass
class BitmapTexture:
    """Bilinear or nearest texel lookup (src/textures/bitmap.cpp); v = 0
    is the top row of ``data``, as the image loaders give it.

    The mip pyramid of the JAX package's ``BitmapTexture.with_mips`` is
    not ported: its trilinear lookup needs ray differentials, which the
    port's integrators do not carry (ROADMAP.md, Queue 1, item 6)."""

    data: torch.Tensor    # (H, W, C) float32, C = 1 or 3
    mips: tuple = ()
    filter_nearest: bool = False
    wrap_repeat: bool = True

    def eval(self, si):
        """The texel value (N, C) at each lane's ``si.uv``: uvs outside
        [0, 1] wrap (``wrap_repeat``) or clamp."""
        if self.mips and getattr(si, "duv_dx", None) is not None:
            raise NotImplementedError(
                "mip-mapped lookups are not ported (ROADMAP.md, Queue 1, "
                "item 6)")
        u, v = si.uv[..., 0], si.uv[..., 1]
        if self.wrap_repeat:
            u = u - torch.floor(u)
            v = v - torch.floor(v)
        else:
            u = torch.clamp(u, 0.0, 1.0)
            v = torch.clamp(v, 0.0, 1.0)
        data = self.data
        h, w = int(data.shape[0]), int(data.shape[1])
        x = u * w - 0.5
        y = (1.0 - v) * h - 0.5
        if self.filter_nearest:
            xi = torch.clamp(torch.round(x).to(torch.int64), 0, w - 1)
            yi = torch.clamp(torch.round(y).to(torch.int64), 0, h - 1)
            return data[yi, xi]
        x0, y0 = torch.floor(x), torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
        x1i = torch.clamp(x0i + 1, 0, w - 1)
        y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        return (data[y0i, x0i] * (1 - fx) * (1 - fy)
                + data[y0i, x1i] * fx * (1 - fy)
                + data[y1i, x0i] * (1 - fx) * fy
                + data[y1i, x1i] * fx * fy)
