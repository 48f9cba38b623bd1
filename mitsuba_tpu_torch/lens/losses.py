"""Spot-size losses for lens design (mitsuba_tpu/lens/losses.py;
reference lens_design/losses.py:8-41 of the fork): the intensity-weighted
second moment, the RMS spot radius squared, of a rendered spot image
about its detached centroid.  An empty image scores 0, as the
reference's does (ROADMAP.md, Queue 3): never read an RMS of 0 as a
sharp spot.
"""
from __future__ import annotations

import torch


def rms_loss_and_center(image):
    """(rms_sq, ibar, jbar) of an (H, W, 3) image (losses.py:31)."""
    scaled = image / torch.clamp(torch.mean(image.detach()), min=1e-20)
    h, w = image.shape[0], image.shape[1]
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=image.device),
        torch.arange(w, dtype=torch.float32, device=image.device),
        indexing="ij")
    intens = torch.mean(scaled, dim=-1)
    inv_sum = 1.0 / torch.clamp(torch.sum(intens), min=1e-20)
    ibar = (torch.sum(ii * intens) * inv_sum).detach()
    jbar = (torch.sum(jj * intens) * inv_sum).detach()
    rms_sq = torch.sum(intens * (torch.square(ii - ibar)
                                 + torch.square(jj - jbar))) * inv_sum
    return rms_sq, ibar, jbar


def rms_loss(image):
    """RMS spot radius squared (losses.py:8)."""
    return rms_loss_and_center(image)[0]
