from .common import render, sample_rays
from .direct import DirectIntegrator
from .megapath import MegakernelPathIntegrator
from .path import PathIntegrator
from .prb import PRBIntegrator, prb_render, prb_render_forward
from .prb_basic import PRBBasicIntegrator
from .ptracer import ParticleTracerIntegrator, render_ptracer

__all__ = ["DirectIntegrator", "MegakernelPathIntegrator",
           "ParticleTracerIntegrator", "PathIntegrator", "PRBBasicIntegrator",
           "PRBIntegrator", "prb_render", "prb_render_forward", "render",
           "render_ptracer", "sample_rays"]
