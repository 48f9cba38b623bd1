"""Textures (mitsuba_tpu/models/textures.py): the constant texture only."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ConstantTexture:
    value: torch.Tensor   # (C,), typically (3,) RGB

    def eval(self, si):
        """The value for each lane of ``si`` (any record with ``uv``)."""
        return self.value.expand(si.uv.shape[0], *self.value.shape)
