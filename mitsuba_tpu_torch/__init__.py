"""mitsuba_tpu_torch: the PyTorch/CUDA port of mitsuba_tpu.

The JAX package ``mitsuba_tpu`` stays the reference; this package keeps
its layout and names, runs on an NVIDIA GPU (sm_90a) with hand-written
CUDA kernels built by nvcc at first use, and imports neither JAX nor
``mitsuba_tpu``.  Entry points run on the GPU unless the caller passes
``device="cpu"``, where every kernel runs as its plain PyTorch version.

Ported so far: the megakernel path for constant-diffuse scenes with one
area light, flat or smooth shading: the brute kernel up to 1024 faces,
``render(cornell_box(), MegakernelPathIntegrator())``, and the BVH
kernels above, ``render(big_scene(), MegakernelPathIntegrator())``.
"""
from .convert import scene_from_numpy
from .device import resolve_device
from .models.integrators import MegakernelPathIntegrator, render, sample_rays
from .utils.scenes import big_scene, cornell_box

__all__ = ["MegakernelPathIntegrator", "big_scene", "cornell_box", "render",
           "resolve_device", "sample_rays", "scene_from_numpy"]
