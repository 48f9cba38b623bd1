#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the kernel
   mitsuba_tpu_torch/csrc/megakernel.cu with nvcc and prints the build
   time and the ptxas report.
2. Holds each kernel against its plain PyTorch version on the card, lane
   by lane, on the Cornell box at 64x64 x 4 spp, depth 6: at least 99.5%
   of lanes within rtol = atol = 2e-3 and the mean within 2e-3 relative
   (the bar of tests/test_megakernel.py: rounding may flip a rare
   russian-roulette or visibility decision).  Step 3 repeats the check
   on the main path's own inputs.
3. Renders BASELINE config 1 through the public entry point,
   render(cornell_box(256, 256), MegakernelPathIntegrator(6, 5), spp=64),
   with every launch counter set to 0 just before and read just after;
   fails unless each kernel of the path launched.  Checks the image is
   finite and of the right shape, and that its mean is within 1e-2
   relative of the plain version's image at the same size.  Times the
   kernel (median of 5, CUDA events) and the plain version on the main
   path's inputs, and computes the kernel's bound from the work this
   run's data needs.
4. Prints one JSON line per the kernels, the card's name and power
   limit again, and last {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line.  It also fails without a GPU, and when run from a directory
that does not hold the mitsuba_tpu_torch package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 7
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores (an FMA counts
# as two operations) and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# float adds, subtracts, multiplies, divides and compares of one
# Moller-Trumbore test (csrc/megakernel.cu tri_test); the shading around
# the tests is left out, so the bound below is a lower bound
OPS_PER_TRI_TEST = 53


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def check_lanes(name, got, ref):
    """The per-lane bar of tests/test_megakernel.py; returns max |got-ref|."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite lanes")
    close = torch.isclose(got, ref, rtol=2e-3, atol=2e-3).all(dim=-1)
    frac = float(close.float().mean())
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
    err = float((got - ref).abs().max())
    print(f"{name}: {frac:.5f} of {got.shape[0]} lanes within 2e-3, "
          f"mean rel err {mean_rel:.3e}, max abs err {err:.3e}")
    if frac < 0.995 or mean_rel >= 2e-3:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "mitsuba_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mitsuba_tpu_torch import MegakernelPathIntegrator, cornell_box, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops import _build
    from mitsuba_tpu_torch.ops.megakernel import (LIGHT_COLS, TRI_COLS,
                                                  megakernel_trace,
                                                  megakernel_trace_plain,
                                                  pack_scene)

    print(gpu_line())
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # ---- 1. build the kernel from source
    t0 = time.perf_counter()
    log = _build.build("megakernel")
    print(f"build: {time.perf_counter() - t0:.1f} s for csrc/megakernel.cu")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  megakernel: {line.strip()}")

    integ = MegakernelPathIntegrator(max_depth=6, rr_depth=5)

    def trace_inputs(scene, spp):
        ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
        tris, light, n_faces, n_lights = pack_scene(scene)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        args = (tris, light, lane, ray.o, ray.d, active, SEED)
        kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                  n_faces=n_faces, n_lights=n_lights)
        return args, kw, weight, film_pos

    # ---- 2. each kernel against its plain version, lane by lane
    args, kw, _, _ = trace_inputs(cornell_box(64, 64), 4)
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    check_lanes("megakernel_trace 64x64x4", got,
                megakernel_trace_plain(*args, **kw))

    # ---- 3. the main path, through the public entry point
    width = height = 256
    spp = 64
    scene = cornell_box(width, height)
    megakernel_trace.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = megakernel_trace.launches
    if launches < 1:
        raise AssertionError("the main path never launched megakernel_trace")
    if tuple(image.shape) != (height, width, 3) \
            or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"bad image: {tuple(image.shape)}")

    args, kw, weight, film_pos = trace_inputs(scene, spp)
    n = int(args[2].shape[0])
    counts = {}
    plain_L = megakernel_trace_plain(*args, **kw, counts=counts)
    film = scene.sensor.film
    plain_image = film.develop(film.put_grouped(film_pos, plain_L * weight,
                                                spp, args[5]))
    rel = abs(float(image.mean()) - float(plain_image.mean())) \
        / float(plain_image.mean())
    print(f"image {width}x{height} x {spp} spp: mean {float(image.mean()):.6f},"
          f" plain {float(plain_image.mean()):.6f}, rel diff {rel:.3e}")
    if rel > 1e-2:
        raise AssertionError("the image mean disagrees with the plain version")

    kernel_L = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    err_full = check_lanes(f"megakernel_trace {width}x{height}x{spp}",
                           kernel_L, plain_L)

    kernel_ms = median_ms(lambda: megakernel_trace(*args, **kw), 5)
    plain_ms = median_ms(lambda: megakernel_trace_plain(*args, **kw), 3)
    tris, light = args[0], args[1]
    ops = (counts["closest_tests"] + counts["shadow_tests"]) * OPS_PER_TRI_TEST
    nbytes = n * (4 + 12 + 12 + 1 + 12) + 4 * (kw["n_faces"] * TRI_COLS
                                                + kw["n_lights"] * LIGHT_COLS)
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"megakernel_trace: {kernel_ms:.4f} ms ({n / kernel_ms * 1e3:.4e} "
          f"rays/s), plain {plain_ms:.2f} ms; closest tests "
          f"{counts['closest_tests']}, shadow tests {counts['shadow_tests']}, "
          f"{ops:.4e} ops -> {t_ops:.4f} ms, {nbytes} bytes -> "
          f"{t_bytes:.4f} ms; render {render_s * 1e3:.2f} ms "
          f"({n / render_s:.4e} rays/s)")

    kernels = [{
        "name": "megakernel_trace",
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/megakernel.cu",
        "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:1805",
        "launches": launches,
        "max_abs_err": err_full,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
