"""Textures (mitsuba_tpu/models/textures.py): the constant texture only."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ConstantTexture:
    value: torch.Tensor   # (C,), typically (3,) RGB
