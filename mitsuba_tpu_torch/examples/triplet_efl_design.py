"""Constrained-EFL lens design (examples/triplet_efl_design.py of the JAX
package; reference design-problem-multi-spot-efl.ipynb of the fork).

A Cooke-triplet-style 6-surface SK16 / F4 / SK16 system whose rear
surface is solved at every step to hold EFL = 50 mm and the focus on the
film plane; the spot sizes of several field angles are optimized with
Adam (ConstrainedEFLProblem, design_problem.py:656).

Run on the GPU: python -m mitsuba_tpu_torch.examples.triplet_efl_design
[--iters N] [--spp N] [--resolution N] [--sources N].
"""
from __future__ import annotations

import argparse

from mitsuba_tpu_torch.lens import (ConicSurface, DesignProblem,
                                    LensMaterial, LensSystem)

# Cooke triplet prescription (curvature radii in mm, film -> world;
# design-problem-multi-spot-efl.ipynb)
TRIPLET_SURFS = [
    dict(radial_extent=6.5, R=-17.285, z0=42.95),
    dict(radial_extent=6.5, R=141.25, z0=44.95),
    dict(radial_extent=5.0, R=19.3, z0=50.95),
    dict(radial_extent=5.0, R=-20.25, z0=51.95),
    dict(radial_extent=6.5, R=-158.65, z0=57.95),
    dict(radial_extent=6.5, R=21.25, z0=59.95),
]
TARGET_EFL = 50.0


def build_triplet(n_rings=8, n_sectors=16, device=None):
    """The triplet with its rear surface solved for EFL = 50 mm, on
    ``device`` (default: the GPU)."""
    surfaces = [ConicSurface.create(s["radial_extent"], 1.0 / s["R"], 0.0,
                                    s["z0"], device=device)
                for s in TRIPLET_SURFS]
    materials = [
        LensMaterial.create("sk16", 1.62041, 60.32),
        LensMaterial.create(),   # air gap
        LensMaterial.create("f4", 1.616592, 36.63),
        LensMaterial.create(),   # air gap
        LensMaterial.create("sk16_b", 1.62041, 60.32),
    ]
    ls = LensSystem.create(surfaces, materials, n_rings=n_rings,
                           n_sectors=n_sectors)
    rear = ls.rear_surface_params_for_EFL(TARGET_EFL)
    s0 = ls.surfaces[0].with_params(rear)
    return ls.replace(surfaces=(s0,) + ls.surfaces[1:])


def make_problem(ls, spp=128, resolution=32, sources=3, iters=30):
    """The example's DesignProblem (max field 7.5 degrees, a 10-degree
    sensor, lr 5e-4), built."""
    return DesignProblem(
        ls, resolution=(resolution, resolution), spp=spp,
        learning_rate=5e-4, iters=iters, num_sources=sources,
        max_field_angle=7.5, sensor_fov=10.0).build()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--sources", type=int, default=3)
    args = ap.parse_args()

    ls = build_triplet()
    print(f"initial EFL = {float(ls.compute_EFL()):.3f} "
          f"(target {TARGET_EFL})")
    print(f"initial BFL = {float(ls.compute_BFL()):.3f} "
          f"(rear z0 = {float(ls.rear_z):.3f})")
    dp = make_problem(ls, args.spp, args.resolution, args.sources, args.iters)
    dp.optimize(fixed_efl=TARGET_EFL, verbose=True)
    print(f"final EFL = {float(dp.lens_system.compute_EFL()):.3f}")
    h = dp.loss_history
    print(f"loss: {h[0]:.1f} -> {h[-1]:.1f}")
    return dp


if __name__ == "__main__":
    main()
