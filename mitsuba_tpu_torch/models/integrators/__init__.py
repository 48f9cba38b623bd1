from .common import render, sample_rays
from .direct import DirectIntegrator
from .megapath import MegakernelPathIntegrator
from .path import PathIntegrator

__all__ = ["DirectIntegrator", "MegakernelPathIntegrator", "PathIntegrator",
           "render", "sample_rays"]
