from .common import render, sample_rays
from .megapath import MegakernelPathIntegrator

__all__ = ["MegakernelPathIntegrator", "render", "sample_rays"]
