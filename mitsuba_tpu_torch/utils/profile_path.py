"""Where the main paths' time goes on the GPU.

    python -m mitsuba_tpu_torch.utils.profile_path

Prints one JSON line for each of the four paths of chip_smoke.py
(max_depth 6, rr_depth 5, seed 7):

1. the Cornell box at BASELINE config 1 (256x256, 64 spp), brute kernel;
2. ``big_scene`` (81,956 triangles, 256x256, 16 spp), BVH kernels with
   the default per-depth sort;
3. and 4. the wavefront ``PathIntegrator`` on both scenes
   (``profile_wavefront``): ``intersect_packed`` on the Cornell box,
   ``packet_closest_hit``/``packet_any_hit`` on ``big_scene``.

Each line holds:

- ``stages_ms``: each stage of one render pass timed alone with CUDA
  events (median of 5): primary rays, scene packing, the kernel(s),
  splat + develop.  For ``big_scene`` also the host BVH build (host
  clock, best of 3) and, for every depth the render ran, the re-sort
  (``megapath._resort`` on the state the previous launch left; the
  Morton gather at depth 0) and the bounce kernel on that depth's sorted
  state, both recorded from the integrator's own run
  (``record_bounces``).  For the wavefront path: ``trace_ctx`` and,
  for every depth the render ran, the closest query, ``compute_si``, NEE
  with its shadow query and BSDF sampling, each on the inputs recorded
  from the integrator's own run (``record_calls``);
- ``render_ms``: the whole ``render`` call by the host clock around a
  synchronised run (median of 5);
- ``device_busy_ms`` / ``device_busy_share``: the sum of GPU kernel time
  that ``torch.profiler`` records over one render, against that render's
  wall time (the rest is the device idling on the host);
- ``top_kernels``: the GPU kernels with the most time in that render;
- ``peak_memory_bytes`` (wavefront path): the render's
  ``torch.cuda.max_memory_allocated()``.

Fails without a GPU.
"""
from __future__ import annotations

import json
import statistics
import time
from contextlib import ExitStack, contextmanager

import torch

from .. import (MegakernelPathIntegrator, PathIntegrator, big_scene,
                cornell_box, render)
from ..models.integrators import megapath, sample_rays
from ..ops.bvh import build_bvh
from ..ops.megakernel import megakernel_trace, pack_scene
from ..ops.megakernel_bvh import (megakernel_bounce_bvh, pack_scene_bvh,
                                  primary_state)

SIZE = 256
SEED = 7


def events_ms(fn, reps=5, setup=None):
    """CUDA-event median of ``reps`` runs of ``fn()``, or of
    ``fn(setup())`` with ``setup`` outside the timed window."""
    times = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn() if setup is None else fn(arg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, reps=5):
    """Host-clock median of ``reps`` synchronised runs of ``fn()``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextmanager
def record_calls(owner, name):
    """Within the block, each call of ``owner.<name>`` (a module's
    function or an object's method) is recorded as (args, kwargs) and
    passed on; yields the list of calls.  The arguments are kept, not
    copied: fit for functions that leave their inputs alone."""
    calls = []
    fn = getattr(owner, name)
    own = name in vars(owner)

    def recording(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(owner, name, recording)
    try:
        yield calls
    finally:
        if own:
            setattr(owner, name, fn)
        else:
            delattr(owner, name)


def record_bounces(integ, scene, ray, lane, seed, active):
    """``integ.sample`` on a BVH scene with every bounce launch recorded.
    Returns the per-lane L and, for each launch, (lane ids, state in,
    state out, depth): the inputs of that depth's kernel and what the
    next depth's re-sort starts from."""
    recorded = []
    launch = megapath.megakernel_bounce_bvh

    def recording(tables, lane, seed, state, depth, **kw):
        state_in = state.clone()
        out = launch(tables, lane, seed, state, depth, **kw)
        recorded.append((lane.clone(), state_in, state.clone(), depth))
        return out

    megapath.megakernel_bounce_bvh = recording
    try:
        L = integ.sample(scene, ray, lane, seed, active)
    finally:
        megapath.megakernel_bounce_bvh = launch
    return L, recorded


def _profile_render(run):
    """Device busy time of one render under torch.profiler."""
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
    return {
        "profiled_render_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_kernel_launches": sum(r[2] for r in rows),
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": c}
                        for k, ms, c in rows[:8]],
    }


def profile_cornell():
    spp = 64
    scene = cornell_box(SIZE, SIZE)
    integ = MegakernelPathIntegrator(max_depth=6, rr_depth=5)
    film = scene.sensor.film

    def run():
        return render(scene, integ, seed=SEED, spp=spp)

    run()   # builds the kernel and warms the allocator
    ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)

    def trace():
        return megakernel_trace(tris, light, lane, ray.o, ray.d, active,
                                SEED, max_depth=6, rr_depth=5,
                                n_faces=n_faces, n_lights=n_lights)

    L = trace()
    stages = {
        "sample_rays": events_ms(lambda: sample_rays(scene, SEED, spp)),
        "pack_scene": events_ms(lambda: pack_scene(scene)),
        "megakernel_trace": events_ms(trace),
        "put_grouped+develop": events_ms(lambda: film.develop(
            film.put_grouped(film_pos, L * weight, spp, active))),
    }
    return {"scene": "cornell_box", "size": SIZE, "spp": spp,
            "stages_ms": stages, "render_ms": wall_ms(run),
            **_profile_render(run)}


def profile_big():
    spp = 16
    scene = big_scene(SIZE, SIZE)
    integ = MegakernelPathIntegrator(max_depth=6, rr_depth=5)
    film = scene.sensor.film

    def run():
        return render(scene, integ, seed=SEED, spp=spp)

    run()
    v, f = scene.geometry()[:2]
    v, f = v.cpu().numpy(), f.cpu().numpy()
    builds = []
    for _ in range(3):
        t0 = time.perf_counter()
        build_bvh(v, f, device=scene.device)
        builds.append((time.perf_counter() - t0) * 1e3)
    ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    tables = pack_scene_bvh(scene)
    stages = {
        "sample_rays": events_ms(lambda: sample_rays(scene, SEED, spp)),
        "bvh_build_host": min(builds),
        "pack_scene_bvh": events_ms(lambda: pack_scene_bvh(scene)),
    }

    # each depth's re-sort and launch, on the states of the integrator's
    # own run (sort_every=1: a re-sort before every depth but the first,
    # which takes the static Morton order)
    L, recorded = record_bounces(integ, scene, ray, lane, SEED, active)
    n = lane.shape[0]
    idx = torch.arange(n, device=lane.device)
    inv_r = 1.0 / max(scene.scene_radius, 1e-6)
    mperm = torch.as_tensor(megapath._morton_perm(film.width, film.height, n),
                            device=lane.device)
    prev = (primary_state(ray.o, ray.d, active), lane.to(torch.int32))
    for rlane, state_in, state_out, depth in recorded:
        if depth == 0:
            stages["sort_depth0"] = events_ms(
                lambda: megapath._gather(mperm, prev[0], prev[1], idx))
        else:
            stages[f"sort_depth{depth}"] = events_ms(
                lambda: megapath._resort(prev[0], prev[1], idx,
                                         scene.scene_center, inv_r))
        stages[f"bounce_depth{depth}"] = events_ms(
            lambda st: megakernel_bounce_bvh(tables, rlane, SEED, st, depth,
                                             6, 5, smooth=True),
            setup=state_in.clone)
        prev = (state_out, rlane)
    stages["put_grouped+develop"] = events_ms(lambda: film.develop(
        film.put_grouped(film_pos, L * weight, spp, active)))
    return {"scene": "big_scene", "triangles": int(f.shape[0]),
            "bvh_nodes": scene.accel.n_nodes, "size": SIZE, "spp": spp,
            "stages_ms": stages, "render_ms": wall_ms(run),
            **_profile_render(run)}


# the wavefront PathIntegrator's stages: Scene methods, by stage name
WAVEFRONT_STAGES = {"closest": "ray_intersect_preliminary",
                    "compute_si": "compute_si",
                    "nee+shadow": "sample_emitter_direction",
                    "bsdf_sample": "bsdf_sample"}


def profile_wavefront(scene, spp):
    """The wavefront PathIntegrator: each stage of each depth timed on the
    inputs that the integrator's own run gave it (``record_calls`` on the
    scene's methods); the rest of a depth (emitter hits, MIS, RR, the
    RNG) shows only in the render."""
    integ = PathIntegrator(max_depth=6, rr_depth=5)
    film = scene.sensor.film

    def run():
        return render(scene, integ, seed=SEED, spp=spp)

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    stages = {"sample_rays": events_ms(lambda: sample_rays(scene, SEED, spp)),
              "trace_ctx": events_ms(scene.trace_ctx)}
    with ExitStack() as stack:
        calls = {k: stack.enter_context(record_calls(scene, m))
                 for k, m in WAVEFRONT_STAGES.items()}
        L = integ.sample(scene, ray, lane, SEED, active)
    for depth in range(len(calls["closest"])):
        for k, m in WAVEFRONT_STAGES.items():
            args, kw = calls[k][depth]
            stages[f"{k}_depth{depth}"] = events_ms(
                lambda: getattr(scene, m)(*args, **kw))
    stages["put_grouped+develop"] = events_ms(lambda: film.develop(
        film.put_grouped(film_pos, L * weight, spp, active)))
    return {"integrator": "path", "size": SIZE, "spp": spp,
            "stages_ms": stages, "render_ms": wall_ms(run),
            "peak_memory_bytes": peak, **_profile_render(run)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: no CUDA device")
    device = torch.cuda.get_device_name(0)
    for profile in (profile_cornell, profile_big):
        print(json.dumps({"device": device, **profile()}))
    print(json.dumps({"device": device, "scene": "cornell_box",
                      **profile_wavefront(cornell_box(SIZE, SIZE), 64)}))
    print(json.dumps({"device": device, "scene": "big_scene",
                      **profile_wavefront(big_scene(SIZE, SIZE), 16)}))


if __name__ == "__main__":
    main()
