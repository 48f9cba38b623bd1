"""Stateless counter-based RNG: u = U(seed, lane, dim) (mitsuba_tpu/core/rng.py).

Every sample is a pure function of a global seed, the lane index
(pixel * spp + sample) and a per-request dimension counter, hashed with
PCG3D (Jarzynski & Olano, JCGT 2020).  The streams are bit-identical to
the JAX package's, which is what lets the port be held against it lane
by lane.

PyTorch has no full uint32 arithmetic on the CPU (no ``>>`` on uint32),
so the hash runs on int64 tensors holding values in [0, 2^32), masked
after every add and multiply.  A product of two 32-bit words does not
fit a signed int64, so ``_mul32`` splits one factor into 16-bit halves.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SEED_XOR = 0xDEADBEEF
_PCG_MUL = 1664525
_PCG_ADD = 1013904223
_INV_2_24 = 1.0 / (1 << 24)


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding uint32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _pcg3d(v0, v1, v2):
    """PCG3D hash: three uint32 words (as int64 tensors) -> three words."""
    v0 = (v0 * _PCG_MUL + _PCG_ADD) & MASK32
    v1 = (v1 * _PCG_MUL + _PCG_ADD) & MASK32
    v2 = (v2 * _PCG_MUL + _PCG_ADD) & MASK32
    v0 = (v0 + _mul32(v1, v2)) & MASK32
    v1 = (v1 + _mul32(v2, v0)) & MASK32
    v2 = (v2 + _mul32(v0, v1)) & MASK32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v0 = (v0 + _mul32(v1, v2)) & MASK32
    v1 = (v1 + _mul32(v2, v0)) & MASK32
    v2 = (v2 + _mul32(v0, v1)) & MASK32
    return v0, v1, v2


def _to_unit(bits):
    """uint32 word -> float32 in [0, 1) from its top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def as_u32(x, like=None):
    """A lane/dim/seed argument (int or integer tensor) as an int64 tensor
    of uint32 values, on ``like``'s device when ``x`` is a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    device = like.device if like is not None else None
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _hash(seed, lane, dim):
    lane = as_u32(lane)
    dim = as_u32(dim, like=lane)
    seed_x = as_u32(seed, like=lane) ^ SEED_XOR
    return _pcg3d(*torch.broadcast_tensors(lane, dim, seed_x))


def sample_1d(seed, lane, dim):
    """One uniform float32 per lane (independent sampler: no stratification)."""
    v0, _, _ = _hash(seed, lane, dim)
    return _to_unit(v0)


def sample_2d(seed, lane, dim):
    """Two uniform float32 per lane, shape (..., 2)."""
    v0, v1, _ = _hash(seed, lane, dim)
    return torch.stack([_to_unit(v0), _to_unit(v1)], dim=-1)
