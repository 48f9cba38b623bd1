"""The command line renderer, the ``mitsuba`` binary's counterpart
(mitsuba_tpu/__main__.py; reference src/mitsuba/mitsuba.cpp): load a
scene file, render it with the scene's own integrator, write an EXR.

    python -m mitsuba_tpu_torch scene.xml|scene.json [-o out.exr] [-s SPP]
        [--seed N] [-D key=value ...] [--device cuda|cpu]

``--device`` defaults to the GPU: without one, the command fails unless
``--device cpu`` asks for the CPU.  The output is an OpenEXR file (or a
PNG, by its extension) written by ``utils/bitmap.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="mitsuba_tpu_torch",
        description="Render a Mitsuba scene file with the PyTorch/CUDA port")
    p.add_argument("scene", help="scene file (.xml) or dict (.json)")
    p.add_argument("-o", "--output", default=None,
                   help="output image (.exr / .png); default <scene>.exr")
    p.add_argument("-s", "--spp", type=int, default=None,
                   help="override the samples per pixel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-D", "--define", action="append", default=[],
                   metavar="KEY=VALUE", help="set an XML $default parameter")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: the GPU)")
    args = p.parse_args(argv)

    import torch

    from .device import resolve_device
    from .models.integrators.common import render
    from .utils.bitmap import write_image
    from .utils.load import load_dict
    from .utils.xml import load_file

    device = resolve_device(args.device)
    defaults = dict(d.partition("=")[::2] for d in args.define)
    t0 = time.time()
    if args.scene.endswith(".json"):
        with open(args.scene) as f:
            scene = load_dict(json.load(f), device=device)
    else:
        scene = load_file(args.scene, defaults, device=device)
    print(f"[mitsuba_tpu_torch] scene loaded in {time.time() - t0:.2f}s "
          f"({len(scene.meshes)} shapes, {len(scene.bsdfs)} bsdfs, "
          f"{len(scene.emitters)} emitters)")
    t0 = time.time()
    img = render(scene, seed=args.seed, spp=args.spp, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[mitsuba_tpu_torch] rendered in {time.time() - t0:.2f}s")
    out = args.output or args.scene.rsplit(".", 1)[0] + ".exr"
    write_image(out, img.detach().cpu().numpy())
    print(f"[mitsuba_tpu_torch] wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
