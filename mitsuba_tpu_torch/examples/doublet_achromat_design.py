"""Achromatic-doublet glass recovery (examples/doublet_achromat_design.py
of the JAX package; reference report_doublet_exp.ipynb of the fork).

A 3-surface cemented doublet whose front glass (the sf11 slot) starts
with a wrong Abbe number (V_d = 0.2 * 64.17); the rear surface is solved
once for EFL = 50 mm; every surface and both refractive indices are then
frozen (learning rate 0) and only the front glass's V_d is optimized
through the spectral particle tracer: the chromatic blur of the spot on
the film gives the gradient.  The achromat condition P1 / V1 + P2 / V2 =
0 (thin-lens powers) gives the optimum V2 = -(P2 / P1) V1 that the
optimization must approach.

Run on the GPU: python -m mitsuba_tpu_torch.examples.doublet_achromat_design
[--iters N] [--spp N] [--resolution N] [--lr X].  Prints the V_d
trajectory and the losses as one JSON line; writes no file.
"""
from __future__ import annotations

import argparse
import json

from mitsuba_tpu_torch.lens import (ConicSurface, DesignProblem,
                                    LensMaterial, LensSystem)

# doublet prescription (report_doublet_exp.ipynb cell 5)
DOUBLET_SURFS = [
    dict(radial_extent=8.0, c=1.0 / 140.0, z0=48.0),
    dict(radial_extent=8.0, c=-1.0 / 24.0, z0=49.0),
    dict(radial_extent=8.0, c=1.0 / 24.0, z0=52.0),
]
TARGET_EFL = 50.0
V_INIT = 0.2 * 64.17          # the wrong starting Abbe number


def build_doublet(n_rings=8, n_sectors=16, device=None):
    """The doublet with its rear surface solved for EFL = 50 mm, on
    ``device`` (default: the GPU)."""
    surfaces = [ConicSurface.create(s["radial_extent"], s["c"], 0.0, s["z0"],
                                    device=device) for s in DOUBLET_SURFS]
    materials = [LensMaterial.create("sf11", 1.6447, V_INIT),
                 LensMaterial.create("nbk7", 1.5168, V_INIT)]
    ls = LensSystem.create(surfaces, materials, n_rings=n_rings,
                           n_sectors=n_sectors)
    rear = ls.rear_surface_params_for_EFL(TARGET_EFL)
    s0 = ls.surfaces[0].with_params(rear)
    return ls.replace(surfaces=(s0,) + ls.surfaces[1:])


def exact_vd(ls):
    """The achromat's front-glass Abbe number (report_doublet_exp.ipynb
    get_exact_Vd; thin-lens powers)."""
    inv_c = float(ls.surfaces[0].params["c"])
    inv_b = -float(ls.surfaces[1].params["c"])
    inv_a = float(ls.surfaces[2].params["c"])
    n1, v1 = float(ls.materials[2].ior), float(ls.materials[2].V_d)
    n2 = float(ls.materials[1].ior)
    p1 = (n1 - 1.0) * (inv_a + inv_b)
    p2 = -(n2 - 1.0) * (inv_b + inv_c)
    return -(p2 / p1) * v1


def make_problem(ls, spp=2048, resolution=24, lr=0.6, iters=40, seed=0):
    """The example's DesignProblem (one source, the sensor at 0.01 of the
    rear z, spectral), built."""
    return DesignProblem(
        ls, resolution=(resolution, resolution), spp=spp, learning_rate=lr,
        iters=iters, num_sources=1, init_camera_z=0.01, seed=seed,
        spectral=True).build()


def run(iters=40, spp=2048, resolution=24, lr=0.6, seed=0, verbose=True,
        device=None):
    ls = build_doublet(device=device)
    v_exact = exact_vd(ls)
    if verbose:
        print(f"EFL = {float(ls.compute_EFL()):.3f} (target {TARGET_EFL})")
        print(f"exact achromat V_d = {v_exact:.3f} (init {V_INIT:.3f})")
    dp = make_problem(ls, spp, resolution, lr, iters, seed)
    # every parameter but the front glass's Abbe number frozen
    frozen = {k: 0.0 for k in dp.params() if k != "mat_sf11_V_d"}
    vd_hist = []

    def cb(it, p, loss):
        vd_hist.append(float(p["mat_sf11_V_d"]))
        if verbose and it % 5 == 0:
            print(f"iter {it:3d}: loss {loss:9.5f}  V_d {vd_hist[-1]:7.3f}  "
                  f"(exact {v_exact:.3f})")

    p = dp.optimize(lr_overrides=frozen, callback=cb)
    return dict(v_init=V_INIT, v_exact=v_exact,
                v_final=float(p["mat_sf11_V_d"]), vd_trajectory=vd_hist,
                loss=dp.loss_history)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--spp", type=int, default=2048)
    ap.add_argument("--resolution", type=int, default=24)
    ap.add_argument("--lr", type=float, default=0.6)
    args = ap.parse_args()
    out = run(iters=args.iters, spp=args.spp, resolution=args.resolution,
              lr=args.lr)
    err0 = abs(out["v_init"] - out["v_exact"])
    err1 = abs(out["v_final"] - out["v_exact"])
    print(f"V_d: {out['v_init']:.3f} -> {out['v_final']:.3f} "
          f"(exact {out['v_exact']:.3f}); |error| {err0:.3f} -> {err1:.3f}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
