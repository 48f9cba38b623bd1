"""Batched interaction records (mitsuba_tpu/core/records.py)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Ray:
    o: torch.Tensor      # (N, 3) origin
    d: torch.Tensor      # (N, 3) unit direction
    maxt: torch.Tensor   # (N,)
