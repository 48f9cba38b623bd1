"""BSDFs (mitsuba_tpu/models/bsdfs.py): the Lambertian BSDF only.

Its sampling and evaluation run inside the megakernel
(ops/megakernel.py); the record here carries its parameters.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SmoothDiffuse:
    """Lambertian reflection (src/bsdfs/diffuse.cpp)."""

    reflectance: object   # texture
