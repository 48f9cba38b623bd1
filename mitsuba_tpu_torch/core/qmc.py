"""Quasi-Monte-Carlo: radical inverse and Halton points
(mitsuba_tpu/core/qmc.py; reference src/core/qmc.cpp), which the lens
camera's exit-pupil table draws its rays from.

PyTorch has no full uint32 arithmetic on the CPU, so the indices live in
int64 tensors holding uint32 (base 2) or int32 (other bases) values,
masked as ``core/rng.py`` masks them; the results are the JAX package's
bit for bit.
"""
from __future__ import annotations

import torch

from .rng import MASK32

_INV_2_32 = 2.3283064365386963e-10


def radical_inverse_2(i):
    """Base-2 radical inverse (bit reversal) of uint32 indices -> [0, 1)."""
    v = torch.as_tensor(i).to(torch.int64) & MASK32
    v = ((v >> 16) | (v << 16)) & MASK32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    v = ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)
    return v.to(torch.float32) * _INV_2_32


def radical_inverse(base: int, i, digits: int = 20):
    """Base-``base`` radical inverse of ``digits`` digits of the indices
    taken as int32 (floor division and modulo, as ``jnp``'s)."""
    if base == 2:
        return radical_inverse_2(i)
    n = torch.as_tensor(i).to(torch.int64)
    n = ((n + (1 << 31)) & MASK32) - (1 << 31)
    inv_base = 1.0 / base
    value = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    factor = torch.tensor(inv_base, dtype=torch.float32, device=n.device)
    for _ in range(digits):
        value = value + (n % base).to(torch.float32) * factor
        factor = factor * inv_base
        n = n // base
    return value


def halton_2d(i):
    """(base 2, base 3) Halton points of the indices -> (..., 2)."""
    return torch.stack([radical_inverse_2(i), radical_inverse(3, i)], dim=-1)
