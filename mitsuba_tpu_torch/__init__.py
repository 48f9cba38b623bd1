"""mitsuba_tpu_torch: the PyTorch/CUDA port of mitsuba_tpu.

The JAX package ``mitsuba_tpu`` stays the reference; this package keeps
its layout and names, runs on an NVIDIA GPU (sm_90a) with hand-written
CUDA kernels built by nvcc at first use, and imports neither JAX nor
``mitsuba_tpu``.  Entry points run on the GPU unless the caller passes
``device="cpu"``, where every kernel runs as its plain PyTorch version.

Ported so far, for scenes of constant diffuse, smooth and GGX rough
conductor and dielectric BSDFs with area lights, flat or smooth shading
and the independent sampler (BASELINE configs 1 and 2):

- the megakernel path for one area light: the brute kernel up to 1024
  faces, ``render(cornell_box(), MegakernelPathIntegrator())``, and the
  BVH kernels above, ``render(big_scene(), MegakernelPathIntegrator())``;
- the wavefront ``PathIntegrator`` over the brute ``intersect_packed``
  kernel up to 1024 faces and the BVH ``packet_closest_hit`` /
  ``packet_any_hit`` kernels above, e.g. ``render(cornell_box(),
  PathIntegrator())``; ``MegakernelPathIntegrator`` falls back to it for
  a scene outside the megakernel subset (two lights, say) or whose BVH
  is deeper than the BVH kernels' walk takes;
- the ``DirectIntegrator``, over the same hit queries as the wavefront.
"""
from .convert import scene_from_numpy
from .device import resolve_device
from .models.integrators import (DirectIntegrator, MegakernelPathIntegrator,
                                 PathIntegrator, render, sample_rays)
from .utils.scenes import big_scene, cornell_box

__all__ = ["DirectIntegrator", "MegakernelPathIntegrator", "PathIntegrator",
           "big_scene", "cornell_box", "render", "resolve_device",
           "sample_rays", "scene_from_numpy"]
