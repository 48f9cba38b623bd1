from .common import render, sample_rays
from .megapath import MegakernelPathIntegrator
from .path import PathIntegrator

__all__ = ["MegakernelPathIntegrator", "PathIntegrator", "render",
           "sample_rays"]
