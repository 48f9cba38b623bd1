"""Samplers (mitsuba_tpu/models/samplers.py): the independent sampler.

A sampler is metadata (sample count and strategy); the draws themselves
are pure functions of (seed, lane, dim) in core/rng.py.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IndependentSampler:
    sample_count: int = 16

    def film_jitter(self, u2, sample_in_pixel):
        """Uniform jitter in the pixel (u2 straight through)."""
        return u2
