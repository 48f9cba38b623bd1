"""Where the main path's time goes on the GPU.

    python -m mitsuba_tpu_torch.utils.profile_path

Renders the Cornell box at BASELINE config 1 (256x256, 64 spp,
max_depth 6, rr_depth 5, seed 7, as in chip_smoke.py) through ``render``
and prints, as one JSON line:

- ``stages_ms``: each stage of one render pass timed alone with CUDA
  events (median of 5): primary rays, scene packing, the megakernel,
  splat + develop;
- ``render_ms``: the whole ``render`` call by the host clock around a
  synchronised run (median of 5);
- ``device_busy_ms`` / ``device_busy_share``: the sum of GPU kernel time
  that ``torch.profiler`` records over one render, against that render's
  wall time (the rest is the device idling on the host);
- ``top_kernels``: the GPU kernels with the most time in that render.

Fails without a GPU.
"""
from __future__ import annotations

import json
import statistics
import time

import torch

from .. import MegakernelPathIntegrator, cornell_box, render
from ..models.integrators import sample_rays
from ..ops.megakernel import megakernel_trace, pack_scene

SIZE = 256
SPP = 64
SEED = 7


def _events_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _wall_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: no CUDA device")

    scene = cornell_box(SIZE, SIZE)
    integ = MegakernelPathIntegrator(max_depth=6, rr_depth=5)
    film = scene.sensor.film

    def run():
        return render(scene, integ, seed=SEED, spp=SPP)

    run()   # builds the kernel and warms the allocator
    ray, weight, film_pos, lane = sample_rays(scene, SEED, SPP)
    tris, light, n_faces, n_lights = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)

    def trace():
        return megakernel_trace(tris, light, lane, ray.o, ray.d, active,
                                SEED, max_depth=6, rr_depth=5,
                                n_faces=n_faces, n_lights=n_lights)

    L = trace()
    stages = {
        "sample_rays": _events_ms(lambda: sample_rays(scene, SEED, SPP)),
        "pack_scene": _events_ms(lambda: pack_scene(scene)),
        "megakernel_trace": _events_ms(trace),
        "put_grouped+develop": _events_ms(lambda: film.develop(
            film.put_grouped(film_pos, L * weight, SPP, active))),
    }
    render_ms = _wall_ms(run)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op also reports its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "size": SIZE, "spp": SPP,
        "stages_ms": stages,
        "render_ms": render_ms,
        "profiled_render_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_kernel_launches": sum(r[2] for r in rows),
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": c}
                        for k, ms, c in rows[:8]],
    }))


if __name__ == "__main__":
    main()
