"""Emitters (mitsuba_tpu/models/emitters.py): the area light only.

Its sampling and evaluation run inside the megakernel
(ops/megakernel.py); the record here carries its parameters.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AreaEmitter:
    """Diffuse area light attached to a shape (src/emitters/area.cpp)."""

    radiance: object              # texture
    sampling_weight: float = 1.0  # relative emitter selection probability
