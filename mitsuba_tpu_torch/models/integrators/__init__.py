from .common import render, sample_rays
from .depth import DepthIntegrator
from .direct import DirectIntegrator
from .megapath import MegakernelPathIntegrator
from .path import PathIntegrator
from .prb import PRBIntegrator, prb_render, prb_render_forward
from .prb_basic import PRBBasicIntegrator
from .projective import (DirectProjectiveIntegrator, PathProjectiveIntegrator,
                         analytic_boundary_grads, build_silhouette_edges,
                         indirect_boundary_grads, prb_projective_render)
from .ptracer import ParticleTracerIntegrator, render_ptracer

__all__ = ["DepthIntegrator", "DirectIntegrator", "DirectProjectiveIntegrator",
           "MegakernelPathIntegrator", "ParticleTracerIntegrator",
           "PathIntegrator", "PathProjectiveIntegrator", "PRBBasicIntegrator",
           "PRBIntegrator", "analytic_boundary_grads",
           "build_silhouette_edges", "indirect_boundary_grads",
           "prb_projective_render",
           "prb_render", "prb_render_forward", "render", "render_ptracer",
           "sample_rays"]
