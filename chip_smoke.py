#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds every native source
   of the port at once, one compiler each: csrc/megakernel.cu,
   csrc/megakernel_bvh.cu, csrc/intersect_packed.cu and csrc/traverse.cu
   with nvcc (printing each kernel's ptxas registers and spills) and the
   host BVH builder csrc/bvh_builder.cpp with g++.
2. Cornell box (brute kernel):
   a. holds megakernel_trace against its plain PyTorch version on the
      card, lane by lane, at 64x64 x 4 spp, depth 6: at least 99.5% of
      lanes within rtol = atol = 2e-3 and the mean within 2e-3 relative
      (the bar of tests/test_megakernel.py: rounding may flip a rare
      russian-roulette or visibility decision);
   b. renders BASELINE config 1 through the public entry point,
      render(cornell_box(256, 256), MegakernelPathIntegrator(6, 5),
      spp=64), with every launch counter set to 0 just before and read
      just after; fails unless megakernel_trace launched.  Checks the
      image (shape, finite, mean within 1e-2 of the plain version's
      image), repeats the lane check on the path's inputs, prints the
      kernel's persistent grid (blocks, resident blocks per SM, threads)
      and the lanes each thread takes on average, and checks the
      schedule on those inputs: the persistent threads take lanes in
      whatever order their paths end, each thread tens of lanes in turn,
      so a second launch, and a launch on a seeded permutation of the
      lanes (un-permuted), must give every lane the same radiance bit
      for bit; with about 10 % of the lanes marked inactive (seeded),
      those must give exactly 0 and the others their radiance of the
      first launch.  Times the kernel (median of 5, CUDA events), the
      plain version and the render (host clock, median of 5).
3. The at-scale scene (BVH kernels): big_scene, the Cornell box plus a
   smooth icosphere, 81,956 triangles; prints the host BVH build time.
   a. holds megakernel_bounce_bvh (six launches, one per depth) and
      megakernel_trace_bvh against their plain versions, lane by lane,
      at 64x64 x 4 spp, depth 6, with the bar of 2a;
   b. renders render(big_scene(256, 256), MegakernelPathIntegrator(6,
      5), seed=7, spp=16) (the default sort_bounces=True) with the
      counters at 0; fails unless megakernel_bounce_bvh launched, at
      most 6 times.  Checks the image as in 2b, and the lane check of the
      path's per-lane radiance against the plain version at full size;
   c. renders again with sort_bounces=False: fails unless
      megakernel_trace_bvh launched, and unless the image mean is within
      1e-5 of 3b's (lanes ride the permutations, so the image is the
      same); repeats the lane check for it.  Prints both kernels'
      persistent grids (blocks, resident blocks per SM, threads, lanes a
      thread) and the tree's depth against the walk's stack cap, and
      checks both schedules at full size: for megakernel_trace_bvh on the
      Morton-ordered lanes the checks of 2b (second launch, permuted
      lanes, 10 % inactive); for megakernel_bounce_bvh on each depth's
      recorded state a second launch on a clone and a launch on a seeded
      permutation of its lanes, which must give that depth's recorded
      state out bit for bit;
   d. times, after warm-up renders: each kernel on the path's inputs
      (CUDA-event median of 5; the bounce kernel once per depth on that
      depth's sorted state, summed over the frame), the plain versions
      once, and both renders (host clock, median of 5, rays/s).
   Each kernel's bound is the larger of its operations (box tests,
   closest and shadow triangle tests that the plain version counts on
   these inputs, over 67 TFLOP/s) and its bytes over 3.35 TB/s: tables
   and inputs read once, output written once; for the bounce kernel,
   at each launch every lane's act flag and, for the live lanes only,
   the lane id and the rest of the state read and the state written.
4. The wavefront PathIntegrator on the Cornell box (intersect_packed):
   a. holds intersect_packed against its plain version, bit for bit
      (t, prim, u and v of every ray), on every call of a 64x64 x 4 spp
      path (primary rays, then each depth's shadow and bounce rays), and
      on the middle rays of that path's primary call under synthetic
      masks: all
      active, about 10 % active, none active (seeded), n = 1, and n one
      below and one above a chunk of slots and a batch of queued rays
      (one a thread; both sizes from the kernel's launch_config), each
      with maxt = inf and with a seeded finite maxt;
   b. renders BASELINE config 1 as written, render(cornell_box(256, 256),
      PathIntegrator(6, 5), seed=7, spp=64), with the counters at 0;
      fails unless intersect_packed launched (at most 12 times) and no
      other kernel did; prints the peak device memory;
   c. holds the path's per-lane radiance against
      MegakernelPathIntegrator's on the same rays (the bar of 2a) and the
      image mean against the megakernel render's (1e-2);
   d. times the render (host clock, median of 5) and, on the path's own
      calls, the kernel (CUDA-event median of 5 a call, summed over the
      frame) and the plain version (once a call, also checked against
      the kernel at full size, bit for bit), and prints the kernel's
      persistent grid (blocks, resident blocks per SM, threads, slots a
      chunk).  The bound is the larger of the tests the plain version
      counts (x 53 operations) over 67 TFLOP/s and
      the bytes over 3.35 TB/s: the face table once a frame (it stays in
      L2 between launches), each ray slot's active flag and 16 bytes
      out, and the other 28 bytes in (o, d, maxt) for an active ray
      only, since an inactive one is settled by its flag.
5. The same on big_scene (render(big_scene(256, 256), PathIntegrator(6,
   5), seed=7, spp=16)) through packet_closest_hit and packet_any_hit,
   held by the bar of 99.99 % of rays (hit, face, t within 1e-5
   relative): each must launch (at most 6 times), every launch by the
   pair route (the two-child walk; the tree is 18 deep), and no other
   kernel; the bound adds node visits x 26 operations (both counts from
   the plain miss-link walk), and the tables the pair walk reads
   (node_pair, leaf_geo, leaf_face) are read once a frame; the outputs
   are 8 (t, face) and 1 (occluded) bytes a ray.  Prints both kernels'
   grid and route (launch_config), each call's ms and active rays, and
   the pair walk's own record visits and tests from its eager twin
   (ops/bvh.py pair_walk), with the rays where kernel and twin differ.
   Checks each kernel's schedule on every call of the path (a second
   launch, and a launch on a seeded permutation of the rays,
   un-permuted, give every ray's outputs bit for bit), then holds both
   kernels against their plain versions by the same bar on the path's
   primary rays under 4a's synthetic masks (all, a tenth, none active;
   n = 1; one ray either side of a warp's chunk of slots and of each
   kernel's grid's total threads, all from launch_config), each with
   maxt = inf and a seeded finite maxt.
6. Fallback through MegakernelPathIntegrator(6, 5), which must launch
   the traversal kernels and no megakernel: big_scene(64, 64) whose
   floor glows too (two area lights), and the Cornell box (64x64) plus
   1,000 triangles in 40 nested clusters, whose BVH is deeper than the
   BVH kernels' walk takes (its image must equal the PathIntegrator's);
   there every hit launch must take the miss-link route (launch_config
   must say so too), and each call of that path is held against the
   plain versions by phase 5's bar.
7. BASELINE config 2 (max_depth 6, rr_depth 5, seed 7): the lobe builds
   of the path kernels, named with their BSDF codes (e.g.
   megakernel_trace[lobes 0,1,2]).
   a. The config-2 Cornell box: the small box a Cu SmoothConductor, the
      large box a SmoothDielectric (eta 1.5), then their GGX rough twins
      (alpha 0.2); each through phase 2's checks and times at 256x256 x
      64 spp (megakernel_trace), then the wavefront PathIntegrator
      (intersect_packed alone; its lanes held against the megakernel's,
      its image within the reference's 2e-2) and the DirectIntegrator
      (held per lane against the CPU's plain queries at 32x32 x 4, then
      at full size through intersect_packed alone); prints the three
      render times.
   b. big_scene with the ball a RoughDielectric (alpha 0.2, eta 1.5)
      and the small box a SmoothConductor (81,956 triangles): phase 3's
      checks, schedule checks and times at 256x256 x 16 spp for both
      BVH kernels, then the wavefront render (packet_closest_hit /
      packet_any_hit) held as in a.
8. Plastic, two-sided and bitmap-textured surfaces (max_depth 6,
   rr_depth 5, seed 7; utils/scenes.py): the surface builds of the path
   kernels, named with their BSDF codes as in 7, through
   MegakernelPathIntegrator(strict=True), which raises rather than fall
   back.
   a. The plastic, two-sided and textured Cornell boxes (the textured
      one's two bitmaps made from the seed), each through phase 2's
      checks and times at 256x256 x 64 spp (megakernel_trace), then the
      wavefront PathIntegrator (intersect_packed alone; lanes and image
      held against the megakernel's as in 7a).
   b. surfaces_big_scene (a RoughPlastic ball, a TwoSided Cu small box;
      81,956 triangles) through phase 3's checks and times at 256x256 x
      16 spp for both BVH kernels, then the wavefront render as in 7b.
   c. Its textured twin (the ball under a 512x512 bitmap): the same for
      megakernel_bounce_bvh alone, which sort_bounces=False must take
      too (megakernel_trace_bvh takes no texture).
   d. The build split: the config-2 scenes' megakernel_trace and
      megakernel_trace_bvh through their lobe build and through the
      surface build, in turns, timed; every lane bit for bit equal.
   build_all prints the ptxas registers and spills of the three builds
   of each path kernel (and of the environment-map builds of phase 9).
9. Environment-map lighting (max_depth 6, rr_depth 5, seed 7;
   utils/scenes.py, under sky_envmap, a 2048 x 1024 sky with a sun made
   from the seed): the environment builds of megakernel_trace and
   megakernel_bounce_bvh (named like megakernel_trace[lobes 0,3 env]),
   through MegakernelPathIntegrator(strict=True).
   a. envmap_scene (a diffuse floor and ball, the envmap alone, no light
      faces) and its twin with the area light before the envmap and a
      rough Cu ball, each through phase 2's checks and times at 256x256 x
      64 spp (megakernel_trace; the plain version's time includes its
      per-depth NEE draws, env_nee_sample, also timed alone at full size),
      then the wavefront PathIntegrator (lanes and image against the
      megakernel's as in 7a) and the DirectIntegrator as in 7a.
   b. envmap_big_scene (the ball 81,920 triangles, the area light and the
      envmap) through megakernel_bounce_bvh alone, sorted and unsorted
      (both must launch it and never megakernel_trace_bvh), with phase 3's
      checks, schedule checks and times at 256x256 x 16 spp, then the
      wavefront render as in 7b.
10. Prints one JSON line of the kernels (the rows of packet_closest_hit
   and packet_any_hit also name their walk, "walk_route"), the card's
   name and power limit again, and last {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line.  It also fails without a GPU, and when run from a directory
that does not hold the mitsuba_tpu_torch package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 7
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores (an FMA counts
# as two operations) and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# float adds, subtracts, multiplies, divides and compares of one
# Moller-Trumbore test (csrc/path_common.cuh tri_test) and of one slab
# test of a node box (csrc/megakernel_bvh.cu: 6 subtractions, 6
# multiplies, 6 per-axis min/max, 3 + 3 reductions and tmax, 1 compare);
# the shading around the tests is left out, so the bounds are lower bounds
OPS_PER_TRI_TEST = 53
OPS_PER_NODE_VISIT = 26
STATE_BYTES = 16 * 4
# what an active ray brings to a hit query besides its active flag (1
# byte, read for every ray): o and d (24 bytes) and maxt (4)
RAY_IN_BYTES = 28
SOURCES = ("megakernel", "megakernel_bvh", "bvh_builder", "intersect_packed",
           "traverse")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_image(name, image, plain_image, width, height):
    import torch

    if tuple(image.shape) != (height, width, 3) \
            or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"{name}: bad image {tuple(image.shape)}")
    rel = abs(float(image.mean()) - float(plain_image.mean())) \
        / float(plain_image.mean())
    print(f"{name} image {width}x{height}: mean {float(image.mean()):.6f}, "
          f"plain {float(plain_image.mean()):.6f}, rel diff {rel:.3e}")
    if rel > 1e-2:
        raise AssertionError(f"{name}: the image mean disagrees with the "
                             "plain version")


def bound(ops, nbytes):
    """(bound ms, what bounds it) of work of ``ops`` float operations and
    ``nbytes`` bytes on the card."""
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def build_all():
    """Every native source at once, one compiler process each."""
    from mitsuba_tpu_torch.ops import _build

    # g++ prints nothing on success, so an empty log does not mean cached
    cached = {s for s in SOURCES if _build.library_path(s).exists()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(str(_build.library_path(s).name) for s in SOURCES)}")
    for name, log in logs.items():
        if name in cached:
            print(f"  {name}: cached, not built, no ptxas report")
        for line in log.splitlines():
            line = line.strip()
            if "Compiling entry function" in line:
                entry = line.split()[-3].strip(chr(39))
                # the builds of a path kernel: template <int LOBES, bool
                # ENV> (the single-launch BVH kernel: <int LOBES>)
                build = {"ILi0E": " [diffuse-only build]",
                         "ILi1E": " [lobe build]",
                         "ILi2E": " [surface build]",
                         "Lb1E": " [environment map]"}
                print(f"  {name}: {entry[:90]}" + "".join(
                    v for k, v in build.items() if k in entry))
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line}")


def cornell_phase(integ, make=None, label="cornell", plain_reps=3):
    """Phase 2 (and 7a, 8a, 9a): the brute kernel on ``make(width,
    height)``, the Cornell box by default; returns its row, the main
    path's image and the render's ms.  The plain version's time is the
    median of ``plain_reps`` runs."""
    import torch

    from mitsuba_tpu_torch import cornell_box, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.megakernel import (LIGHT_COLS, TRI_COLS,
                                                  env_nee_sample, env_view,
                                                  launch_config,
                                                  megakernel_trace,
                                                  megakernel_trace_plain,
                                                  pack_scene, scene_btypes)
    from mitsuba_tpu_torch.utils.profile_path import events_ms, wall_ms

    make = make or cornell_box

    def trace_inputs(scene, spp):
        ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
        tris, light, n_faces, n_lights, tex, env = pack_scene(scene)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        args = (tris, light, lane, ray.o, ray.d, active, SEED)
        kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                  n_faces=n_faces, n_lights=n_lights,
                  btypes=scene_btypes(scene), tex=tex, **env,
                  smooth=any(m.normals is not None for m in scene.meshes))
        return args, kw, weight, film_pos

    # ---- 2a. the kernel against its plain version, lane by lane
    args, kw, _, _ = trace_inputs(make(64, 64), 4)
    env = "env_data" in kw
    name = variant_name("megakernel_trace", kw["btypes"], env)
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    check_lanes(f"{name} {label} 64x64x4", got,
                megakernel_trace_plain(*args, **kw))

    # ---- 2b. the main path, through the public entry point
    width = height = 256
    spp = 64
    scene = make(width, height)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = require_launches(f"{label} megakernel render",
                                {"megakernel_trace": 1})["megakernel_trace"]

    args, kw, weight, film_pos = trace_inputs(scene, spp)
    n = int(args[2].shape[0])
    counts = {}
    plain_L = megakernel_trace_plain(*args, **kw, counts=counts)
    film = scene.sensor.film
    check_image(label, image, film.develop(film.put_grouped(
        film_pos, plain_L * weight, spp, args[5])), width, height)

    kernel_L = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    err_full = check_lanes(f"{name} {label} {width}x{height}x{spp}",
                           kernel_L, plain_L)

    grid = launch_config(kw["n_faces"], kw["n_lights"], n, kw["btypes"], env)
    print(f"{name} grid at {n} lanes: {grid}, "
          f"{n / (grid['blocks'] * grid['threads']):.1f} lanes a thread")
    tris, light, lane, o, d, active, seed = args
    check_schedule(name,
                   lambda *lanes: megakernel_trace(tris, light, *lanes, seed,
                                                   **kw),
                   lane, o, d, active, kernel_L)
    kernel_ms = events_ms(lambda: megakernel_trace(*args, **kw), 5)
    plain_ms = events_ms(lambda: megakernel_trace_plain(*args, **kw),
                         plain_reps)
    if env:
        # the plain version's NEE draws of the environment map alone: the
        # eager counterpart of the JAX package's per-(lane, depth) table
        ev = env_view(kw["env_data"], kw["env_meta"], kw["env_pos"])
        table_ms = events_ms(lambda: [
            env_nee_sample(ev, SEED, args[2], depth)
            for depth in range(integ.max_depth)], 3)
        print(f"{name} {label}: env_nee_sample over {integ.max_depth} "
              f"depths of {n} lanes (the plain NEE table): {table_ms:.3f} ms")
    render_ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 5)
    ops = (counts["closest_tests"] + counts["shadow_tests"]) * OPS_PER_TRI_TEST
    # a textured hit also reads its texels, an escape or an environment
    # NEE sample the map's texels and CDF entries (tex_floats and
    # env_floats, counted by the plain version)
    nbytes = n * (4 + 12 + 12 + 1 + 12) + 4 * (kw["n_faces"] * TRI_COLS
                                                + kw["n_lights"] * LIGHT_COLS
                                                + counts.get("tex_floats", 0)
                                                + counts.get("env_floats", 0))
    bound_ms, bound_by, t_ops, t_bytes = bound(ops, nbytes)
    print(f"{name} {label}: {kernel_ms:.4f} ms "
          f"({n / kernel_ms * 1e3:.4e} rays/s), plain {plain_ms:.2f} ms; "
          "closest tests "
          f"{counts['closest_tests']}, shadow tests {counts['shadow_tests']}, "
          f"texel floats {counts.get('tex_floats', 0)}, env floats "
          f"{counts.get('env_floats', 0)}, "
          f"{ops:.4e} ops -> {t_ops:.4f} ms, {nbytes} bytes -> "
          f"{t_bytes:.4f} ms; first render {render_s * 1e3:.2f} ms, render "
          f"{render_ms:.3f} ms ({n / render_ms * 1e3:.4e} rays/s, median "
          "of 5)")
    return {
        "name": name,
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/megakernel.cu",
        "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:1805",
        "launches": launches,
        "max_abs_err": err_full,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, image, render_ms


def variant_name(kernel, btypes, env=False):
    """A kernel's name in the kernels line: the diffuse-only build under
    its own name, the lobe and surface builds with the BSDF codes they
    ran, and an environment map's build with "env" after them."""
    if tuple(btypes) == (0,) and not env:
        return kernel
    return (f"{kernel}[lobes {','.join(str(b) for b in btypes)}"
            + (" env]" if env else "]"))


def check_schedule(name, trace, lane, o, d, active, first):
    """The schedule checks of a persistent whole-path kernel on the lanes
    whose first launch gave ``first``; ``trace(lane, o, d, active)``
    launches it.  A second launch, a launch on a seeded permutation of
    the lanes and a launch with about 10 % of the lanes inactive agree
    with the first bit for bit (inactive lanes give exactly 0)."""
    import torch

    n = int(lane.shape[0])
    g = torch.Generator(device=lane.device).manual_seed(SEED)
    perm = torch.randperm(n, generator=g, device=lane.device)
    again = trace(lane, o, d, active)
    permuted = trace(lane[perm], o[perm], d[perm], active[perm])
    unpermuted = torch.empty_like(permuted)
    unpermuted[perm] = permuted
    some = active & (torch.rand(n, generator=g, device=lane.device) >= 0.1)
    masked = trace(lane, o, d, some)
    torch.cuda.synchronize()
    checks = {
        "second launch": torch.equal(again, first),
        "permuted lanes": torch.equal(unpermuted, first),
        "inactive lanes give 0": bool((masked[~some] == 0).all()),
        "active lanes unchanged": torch.equal(masked[some], first[some]),
    }
    print(f"{name} schedule, {n} lanes, {int((~some).sum())} inactive: "
          f"{checks}")
    if not all(checks.values()):
        raise AssertionError(f"{name}: a lane's radiance depends on the "
                             "schedule")


def check_bounce_schedule(name, bounce, recorded):
    """The schedule checks of the persistent bounce kernel on each depth's
    recorded state (lane ids, state in, state out, depth): a second launch
    on a clone of the state and a launch on a seeded permutation of its
    lanes (un-permuted) give the recorded state out bit for bit."""
    import torch

    for rlane, s_in, s_out, depth in recorded:
        n = int(rlane.shape[0])
        g = torch.Generator(device=rlane.device).manual_seed(SEED + depth)
        perm = torch.randperm(n, generator=g, device=rlane.device)
        again = bounce(rlane, s_in.clone(), depth)
        permuted = bounce(rlane[perm], s_in[:, perm].contiguous(), depth)
        unpermuted = torch.empty_like(permuted)
        unpermuted[:, perm] = permuted
        torch.cuda.synchronize()
        checks = {"second launch": same_bits(again, s_out),
                  "permuted lanes": same_bits(unpermuted, s_out)}
        print(f"{name} schedule, depth {depth}, "
              f"{int((s_in[15] > 0.5).sum())} live of {n} lanes: {checks}")
        if not all(checks.values()):
            raise AssertionError(f"{name}: a lane's state depends on the "
                                 "schedule")


def kernel_wrappers():
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from mitsuba_tpu_torch.ops.intersect_packed import intersect_packed
    from mitsuba_tpu_torch.ops.megakernel import megakernel_trace
    from mitsuba_tpu_torch.ops.megakernel_bvh import (megakernel_bounce_bvh,
                                                      megakernel_trace_bvh)
    from mitsuba_tpu_torch.ops.traverse import (packet_any_hit,
                                                packet_closest_hit)

    return {fn.__name__: fn for fn in (
        megakernel_trace, megakernel_bounce_bvh, megakernel_trace_bvh,
        intersect_packed, packet_closest_hit, packet_any_hit)}


def reset_counters():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


def require_route(label, route):
    """Fails unless every launch of the hit queries since the reset took
    the walk ``route`` ("pair" or "miss_link")."""
    from mitsuba_tpu_torch.ops import traverse as tv

    for fn in (tv.packet_closest_hit, tv.packet_any_hit):
        print(f"{label}: {fn.__name__} launches by route {fn.routes}")
        if fn.routes[route] != fn.launches:
            raise AssertionError(f"{label}: {fn.__name__} launched off the "
                                 f"{route} route")


def require_launches(label, allowed):
    """The launch counts since the reset; fails unless each kernel named in
    ``allowed`` (name -> most launches) launched 1..most times and no
    other kernel launched."""
    got = {name: fn.launches for name, fn in kernel_wrappers().items()}
    print(f"{label}: launches {got}")
    for name, n in got.items():
        if not (1 <= n <= allowed[name] if name in allowed else n == 0):
            raise AssertionError(f"{label}: {name} launched {n} times")
    return got


def bvh_phase(integ, make=None, label="big_scene", single_launch=True):
    """Phase 3 (and 7b, 8b, 8c, 9b): the BVH kernels on ``make(width,
    height)``, the 81,956-triangle scene by default; returns their rows,
    the sorted render's image and the renders' ms.  Without
    ``single_launch`` (a textured scene or an environment map, which
    megakernel_trace_bvh does not take) only the per-depth pipeline runs:
    megakernel_bounce_bvh's checks and row, and sort_bounces=False must
    launch it too."""
    import torch

    import mitsuba_tpu_torch.models.integrators.megapath as megapath
    from mitsuba_tpu_torch import big_scene, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.bvh import build_bvh
    from mitsuba_tpu_torch.ops.megakernel import scene_btypes
    from mitsuba_tpu_torch.ops.megakernel_bvh import (
        launch_config, megakernel_bounce_bvh, megakernel_bounce_bvh_plain,
        megakernel_trace_bvh, megakernel_trace_bvh_plain, pack_scene_bvh,
        primary_state)
    from mitsuba_tpu_torch.utils.profile_path import (events_ms,
                                                      record_bounces, wall_ms)

    make = make or big_scene

    def inputs(scene, spp):
        ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        return ray, weight, film_pos, lane, active

    width = height = 256
    spp = 16
    t0 = time.perf_counter()
    scene = make(width, height)
    btypes = scene_btypes(scene)
    env = scene.env_index >= 0
    depth_kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                    smooth=True, btypes=btypes)
    names = {k: variant_name(f"megakernel_{k}_bvh", btypes, env)
             for k in ("bounce", "trace")}
    print(f"{label}({width}, {height}): {time.perf_counter() - t0:.3f} s, "
          f"{sum(int(m.faces.shape[0]) for m in scene.meshes)} triangles, "
          f"{scene.accel.n_nodes} BVH nodes, BSDF codes {btypes}")
    if make is big_scene:
        v, f = scene.geometry()[:2]
        v, f = v.cpu().numpy(), f.cpu().numpy()
        build_s = min(_timed(lambda: build_bvh(v, f, device=scene.device))
                      for _ in range(3))
        print(f"host BVH build of {f.shape[0]} triangles: "
              f"{build_s * 1e3:.2f} ms (best of 3)")

    # ---- 3a. each kernel against its plain version, lane by lane
    small = make(64, 64)
    tables = pack_scene_bvh(small)
    ray, _, _, lane, active = inputs(small, 4)
    got = primary_state(ray.o, ray.d, active)
    ref = got.clone()
    for depth in range(integ.max_depth):
        megakernel_bounce_bvh(tables, lane, SEED, got, depth, **depth_kw)
        ref = megakernel_bounce_bvh_plain(tables, lane, SEED, ref, depth,
                                          **depth_kw)
    torch.cuda.synchronize()
    check_lanes(f"{names['bounce']} {label} 64x64x4", got[6:9].T, ref[6:9].T)
    if single_launch:
        got = megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, SEED,
                                   **depth_kw)
        torch.cuda.synchronize()
        check_lanes(f"{names['trace']} {label} 64x64x4", got,
                    megakernel_trace_bvh_plain(tables, lane, ray.o, ray.d,
                                               active, SEED, **depth_kw))

    # ---- 3b. the main path, through the public entry point
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    first_render_s = time.perf_counter() - t0
    bounce_launches = megakernel_bounce_bvh.launches
    print(f"render sort_bounces=True: launches bounce_bvh {bounce_launches}, "
          f"trace_bvh {megakernel_trace_bvh.launches}; first render "
          f"{first_render_s * 1e3:.2f} ms")
    if not 1 <= bounce_launches <= integ.max_depth:
        raise AssertionError("the main path launched megakernel_bounce_bvh "
                             f"{bounce_launches} times, not 1..6")

    tables = pack_scene_bvh(scene)
    ray, weight, film_pos, lane, active = inputs(scene, spp)
    n = int(lane.shape[0])
    counts = {}
    t0 = time.perf_counter()
    plain_L = megakernel_trace_bvh_plain(tables, lane, ray.o, ray.d, active,
                                         SEED, **depth_kw, counts=counts)
    torch.cuda.synchronize()
    plain_trace_ms = (time.perf_counter() - t0) * 1e3
    film = scene.sensor.film
    check_image(f"{label} sorted", image, film.develop(film.put_grouped(
        film_pos, plain_L * weight, spp, active)), width, height)

    # the path's own per-lane radiance, recording each depth's inputs
    sorted_L, recorded = record_bounces(integ, scene, ray, lane, SEED, active)
    torch.cuda.synchronize()
    err_bounce = check_lanes(
        f"{names['bounce']} {label} {width}x{height}x{spp} (sorted path)",
        sorted_L, plain_L)

    # ---- 3c. one launch for every depth
    unsorted = megapath.MegakernelPathIntegrator(
        integ.max_depth, integ.rr_depth, sort_bounces=False)
    reset_counters()
    image_unsorted = render(scene, unsorted, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    trace_launches = megakernel_trace_bvh.launches
    diff = abs(float(image_unsorted.mean()) - float(image.mean()))
    print(f"render sort_bounces=False: launches trace_bvh {trace_launches}, "
          f"bounce_bvh {megakernel_bounce_bvh.launches}; image mean "
          f"{float(image_unsorted.mean()):.7f} vs sorted "
          f"{float(image.mean()):.7f}, diff {diff:.3e}")
    if diff > 1e-5:
        raise AssertionError("sort_bounces=False changed the image")
    if not single_launch:
        if trace_launches or not megakernel_bounce_bvh.launches:
            raise AssertionError("sort_bounces=False on a textured or "
                                 "environment-lit scene did not take the "
                                 "per-depth pipeline")
    elif trace_launches < 1:
        raise AssertionError("sort_bounces=False never launched "
                             "megakernel_trace_bvh")
    if single_launch:
        perm = torch.as_tensor(megapath._morton_perm(width, height, n),
                               device=lane.device)
        m_args = (tables, lane[perm], ray.o[perm], ray.d[perm], active[perm],
                  SEED)
        trace_L = megakernel_trace_bvh(*m_args, **depth_kw)
        torch.cuda.synchronize()
        err_trace = check_lanes(
            f"{names['trace']} {label} {width}x{height}x{spp} (Morton order)",
            trace_L, plain_L[perm])

    # the persistent grids, and their schedule checks at full size
    kernels = ("trace", "bounce") if single_launch else ("bounce",)
    for kernel in kernels:
        grid = launch_config(kernel, n, btypes, env and kernel == "bounce")
        print(f"{names[kernel]} grid at {n} lanes: {grid}, "
              f"{n / (grid['blocks'] * grid['threads']):.1f} lanes a thread;"
              f" tree depth {tables.depth} of a stack cap of "
              f"{grid['stack_cap']}")
    if single_launch:
        check_schedule(names["trace"],
                       lambda *lanes: megakernel_trace_bvh(
                           tables, *lanes, SEED, **depth_kw),
                       *m_args[1:5], trace_L)
    check_bounce_schedule(
        names["bounce"], lambda rlane, st, depth: megakernel_bounce_bvh(
            tables, rlane, SEED, st, depth, **depth_kw), recorded)

    # ---- 3d. times
    render_ms = {}
    for name, it in (("sorted", integ), ("unsorted", unsorted)):
        render(scene, it, seed=SEED, spp=spp)
        render_ms[name] = wall_ms(lambda: render(scene, it, seed=SEED,
                                                 spp=spp), 5)
        print(f"{label} render {name}: {render_ms[name]:.3f} ms, "
              f"{n / render_ms[name] * 1e3:.4e} rays/s")
    bounce_ms = []
    plain_bounce_ms = 0.0
    for rlane, rstate, _, depth in recorded:
        bounce_ms.append(events_ms(
            lambda st: megakernel_bounce_bvh(tables, rlane, SEED, st, depth,
                                             **depth_kw),
            5, setup=rstate.clone))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        megakernel_bounce_bvh_plain(tables, rlane, SEED, rstate, depth,
                                    **depth_kw)
        torch.cuda.synchronize()
        plain_bounce_ms += (time.perf_counter() - t0) * 1e3
    print(f"{names['bounce']} {label} per depth ms: "
          + ", ".join(f"{t:.4f}" for t in bounce_ms)
          + f"; sum {sum(bounce_ms):.4f}, plain {plain_bounce_ms:.1f}")

    ops = (counts["node_visits"] * OPS_PER_NODE_VISIT
           + (counts["closest_tests"] + counts["shadow_tests"])
           * OPS_PER_TRI_TEST)
    # every lane's act is read; only a live lane goes on to read its lane
    # id and the rest of its state and to write the state back; a textured
    # hit also reads its texels, an escape or an environment NEE sample the
    # map's texels and CDF entries
    live = [int((rstate[15] > 0.5).sum()) for _, rstate, _, _ in recorded]
    texels = 4 * (counts.get("tex_floats", 0) + counts.get("env_floats", 0))
    b_bytes = tables.nbytes + texels + sum(
        4 * n + k * (4 + (STATE_BYTES - 4) + STATE_BYTES) for k in live)
    t_bytes_in = tables.nbytes + texels + n * (4 + 12 + 12 + 1 + 12)
    b_bound, b_by, t_ops, b_t = bound(ops, b_bytes)
    t_bound, t_by, _, t_t = bound(ops, t_bytes_in)
    print(f"work: {counts['node_visits']} node visits, "
          f"{counts['closest_tests']} closest tests, {counts['shadow_tests']} "
          f"shadow tests, {texels} texel bytes -> {ops:.4e} ops, "
          f"{t_ops:.4f} ms; live lanes per depth {live}; bytes bounce "
          f"{b_bytes} -> {b_t:.4f} ms, trace {t_bytes_in} -> {t_t:.4f} ms")

    common = {"route": "cuda",
              "source": "mitsuba_tpu_torch/csrc/megakernel_bvh.cu",
              "library_ms": None}
    rows = [{"name": names["bounce"], **common,
             "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:2206",
             "launches": bounce_launches, "max_abs_err": err_bounce,
             "ms": sum(bounce_ms), "plain_ms": plain_bounce_ms,
             "bound_ms": b_bound, "bound_by": b_by}]
    if single_launch:
        trace_ms = events_ms(lambda: megakernel_trace_bvh(*m_args,
                                                          **depth_kw), 5)
        print(f"{names['trace']} {label}: {trace_ms:.4f} ms, plain "
              f"{plain_trace_ms:.1f} ms")
        rows.append({"name": names["trace"], **common,
                     "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:1931",
                     "launches": trace_launches, "max_abs_err": err_trace,
                     "ms": trace_ms, "plain_ms": plain_trace_ms,
                     "bound_ms": t_bound, "bound_by": t_by})
    return rows, image, render_ms


def check_hits(name, t, prim, t_ref, prim_ref):
    """Hit queries against their plain versions: hit and prim agree on at
    least 99.99 % of rays, t within 1e-5 relative.  Returns the largest
    |t - t_ref| where both hit."""
    import torch

    hit, hit_ref = torch.isfinite(t), torch.isfinite(t_ref)
    both = hit & hit_ref
    same = (hit == hit_ref) & (prim.long() == prim_ref.long())
    dt = (t[both] - t_ref[both]).abs()
    same[both] &= dt <= 1e-5 * t_ref[both].abs()
    frac = float(same.float().mean())
    err = float(dt.max()) if dt.numel() else 0.0
    print(f"{name}: {frac:.6f} of {t.shape[0]} rays agree, "
          f"{float(hit.float().mean()):.4f} hit, max |dt| {err:.3e}")
    if frac < 0.9999:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def check_exact_hits(name, got, ref):
    """A hit query that must equal its plain version bit for bit: t, prim,
    u and v of every ray.  Returns the largest |dt| (0)."""
    import torch

    same = [torch.equal(a, b) for a, b in zip(got, ref)]
    hit = torch.isfinite(got[0])
    print(f"{name}: t, prim, u, v bitwise equal {same} over "
          f"{got[0].shape[0]} rays, {float(hit.float().mean()):.4f} hit")
    if not all(same):
        raise AssertionError(f"{name}: kernel differs from the plain version")
    return 0.0


def check_masks(tris, o, d):
    """Phase 4a's synthetic masks: intersect_packed against its plain
    version, bit for bit, on the rays (o, d) under each mask and ray
    count (the middle rays of the call, where most hit), with maxt = inf
    and with a seeded finite maxt."""
    import torch

    from mitsuba_tpu_torch.ops import intersect_packed as ip

    n = int(o.shape[0])
    grid = ip.launch_config(int(tris.shape[1]), n)
    g = torch.Generator(device=o.device).manual_seed(SEED)
    half = torch.rand(n, generator=g, device=o.device) < 0.5
    ones = torch.ones(n, dtype=torch.bool, device=o.device)
    masks = {"all active": ones,
             "about 10 % active":
                 torch.rand(n, generator=g, device=o.device) < 0.1,
             "none active": ~ones, "n = 1": ones[:1]}
    for k in (grid["chunk"] - 1, grid["chunk"] + 1, grid["threads"] - 1,
              grid["threads"] + 1):
        masks[f"n = {k}, half active"] = half[:k]
    # primary hits of the Cornell box lie at t of about 3 to 5
    finite = 8.0 * torch.rand(n, generator=g, device=o.device)
    for label, mask in masks.items():
        k = int(mask.shape[0])
        mid = slice((n - k) // 2, (n - k) // 2 + k)
        for maxt in (torch.full((k,), float("inf"), device=o.device),
                     finite[:k]):
            args = (tris, o[mid], d[mid], maxt, mask)
            check_exact_hits(f"intersect_packed mask {label}, "
                             f"finite maxt {bool(torch.isfinite(maxt[0]))}",
                             ip.intersect_packed(*args),
                             ip.intersect_packed_plain(*args))


def check_occluded(name, occ, occ_ref):
    """Any-hit queries: at least 99.99 % of rays agree.  Returns the
    largest |occ - occ_ref| (0 or 1)."""
    frac = float((occ == occ_ref).float().mean())
    print(f"{name}: {frac:.6f} of {occ.shape[0]} rays agree, "
          f"{float(occ.float().mean()):.4f} occluded")
    if frac < 0.9999:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return float(frac < 1.0)


def hold_calls(name, calls, q):
    """Each recorded call (args, kwargs) of hit query ``q`` through its
    kernel and its plain version: checks them against each other and sums
    over the calls the kernel's CUDA-event median of 5, the plain version's
    single run, its work counts and the bytes: the tables its kernel reads
    once (they stay in L2 between the frame's launches), each ray's active
    flag and outputs, and o, d and maxt of an active ray.  Also returns
    each call's active rays and kernel ms."""
    import torch

    from mitsuba_tpu_torch.utils.profile_path import events_ms

    plain_ms = err = 0.0
    counts, n_active, call_ms = {}, [], []
    nbytes = q["table_bytes"](calls[0][0][0])
    for i, (args, kw) in enumerate(calls):
        got = q["kernel"](*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = q["plain"](*args, **kw, counts=counts)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        err = max(err, q["check"](f"{name} call {i}", got, ref))
        call_ms.append(events_ms(lambda: q["kernel"](*args, **kw), 5))
        n_active.append(int(args[4].sum()))
        nbytes += (int(args[1].shape[0]) * (1 + q["out_bytes"])
                   + n_active[-1] * RAY_IN_BYTES)
    return sum(call_ms), plain_ms, err, counts, nbytes, n_active, call_ms


def hit_queries():
    """The wavefront's hit queries: what chip_smoke needs of each."""
    from mitsuba_tpu_torch.ops import intersect_packed as ip
    from mitsuba_tpu_torch.ops import traverse as tv

    def hits(name, got, ref):
        return check_hits(name, got[0], got[1], ref[0], ref[1])

    def walk_bytes(tables):
        """The tables the kernels' walk reads on the tree's route."""
        read = ((tables.node_pair, tables.leaf_geo, tables.leaf_face)
                if tv.route_for(tables.depth) == "pair" else tables.tensors())
        return sum(x.numel() * x.element_size() for x in read)

    return {
        "intersect_packed": dict(
            kernel=ip.intersect_packed, plain=ip.intersect_packed_plain,
            check=check_exact_hits, out_bytes=16,
            table_bytes=lambda tris: tris.nbytes,
            source="csrc/intersect_packed.cu",
            replaces="mitsuba_tpu/ops/pallas/intersect_pallas.py:125"),
        "packet_closest_hit": dict(
            kernel=tv.packet_closest_hit, plain=tv.packet_closest_hit_plain,
            check=hits, out_bytes=8, table_bytes=walk_bytes,
            kind="closest", source="csrc/traverse.cu",
            replaces="mitsuba_tpu/ops/pallas/traverse.py:2133"),
        "packet_any_hit": dict(
            kernel=tv.packet_any_hit, plain=tv.packet_any_hit_plain,
            check=check_occluded, out_bytes=1, table_bytes=walk_bytes,
            kind="any", source="csrc/traverse.cu",
            replaces="mitsuba_tpu/ops/pallas/traverse.py:2240"),
    }


def same_outputs(a, b):
    """Two outputs of a hit query equal bit for bit: (t, face) or
    occluded."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return same_bits(a[0], b[0]) and torch.equal(a[1], b[1])


def take(out, idx):
    """The rays ``idx`` of a hit query's output."""
    import torch

    return out[idx] if isinstance(out, torch.Tensor) else tuple(
        x[idx] for x in out)


def hit_grids(n, depth):
    """Prints and returns both BVH hit kernels' launch over n rays of a
    tree ``depth`` deep (launch_config: grid, route)."""
    from mitsuba_tpu_torch.ops import traverse as tv

    grids = {kind: tv.launch_config(n, depth, kind)
             for kind in ("closest", "any")}
    for kind, grid in grids.items():
        print(f"packet_{kind}_hit grid at {n} rays, tree {depth} deep: "
              f"{grid}")
    return grids


def check_hit_masks(tables, o, d):
    """Phase 5's synthetic masks: packet_closest_hit and packet_any_hit
    against their plain versions, by check_hits' and check_occluded's bar,
    on the rays (o, d) under each mask and ray count (the middle rays of
    the call, where most hit): all active, about 10 % active, none
    active, n = 1, and n one below and one above a warp's chunk of slots
    and each kernel's grid's total threads (all from launch_config),
    each with maxt = inf and with a seeded finite maxt."""
    import torch

    from mitsuba_tpu_torch.ops import traverse as tv

    q = hit_queries()
    n = int(o.shape[0])
    grids = [tv.launch_config(n, tables.depth, kind)
             for kind in ("closest", "any")]
    g = torch.Generator(device=o.device).manual_seed(SEED)
    half = torch.rand(n, generator=g, device=o.device) < 0.5
    ones = torch.ones(n, dtype=torch.bool, device=o.device)
    masks = {"all active": ones,
             "about 10 % active":
                 torch.rand(n, generator=g, device=o.device) < 0.1,
             "none active": ~ones, "n = 1": ones[:1]}
    sizes = {grids[0]["chunk"]} | {c["blocks"] * c["threads"] for c in grids}
    for k in sorted(sizes):
        for m in (k - 1, k + 1):
            masks[f"n = {m}, half active"] = half[:m]
    # primary hits of big_scene lie at t of about 3 to 6
    finite = 8.0 * torch.rand(n, generator=g, device=o.device)
    for label, mask in masks.items():
        k = int(mask.shape[0])
        mid = slice((n - k) // 2, (n - k) // 2 + k)
        for maxt in (torch.full((k,), float("inf"), device=o.device),
                     finite[:k]):
            args = (tables, o[mid], d[mid], maxt, mask)
            for name in ("packet_closest_hit", "packet_any_hit"):
                q[name]["check"](
                    f"{name} mask {label}, finite maxt "
                    f"{bool(torch.isfinite(maxt[0]))}",
                    q[name]["kernel"](*args), q[name]["plain"](*args))


def check_hit_schedule(name, kernel, calls):
    """On each recorded call of a hit kernel, a second launch and a launch
    on a seeded permutation of the rays (un-permuted) must give every
    ray's outputs bit for bit: the warps take slots in whatever order
    their walks end."""
    import torch

    for i, (args, kw) in enumerate(calls):
        tables, o, d, maxt, active = args
        first = kernel(*args, **kw)
        g = torch.Generator(device=o.device).manual_seed(SEED + i)
        perm = torch.randperm(int(o.shape[0]), generator=g, device=o.device)
        checks = {"second launch": same_outputs(kernel(*args, **kw), first),
                  "permuted rays": same_outputs(
                      kernel(tables, o[perm], d[perm], maxt[perm],
                             active[perm]), take(first, perm))}
        print(f"{name} schedule, call {i}, {int(active.sum())} active of "
              f"{int(o.shape[0])} rays: {checks}")
        if not all(checks.values()):
            raise AssertionError(f"{name}: a ray's outputs depend on the "
                                 "schedule")


def pair_twin(name, q, calls):
    """The pair walk's own work on the path's calls, from its eager twin
    (ops/bvh.py pair_walk), printed as information beside the bound, with
    the rays where the twin and the kernel differ."""
    import torch

    from mitsuba_tpu_torch.ops import bvh

    counts, differ = {}, 0
    for args, kw in calls:
        tables, o, d, maxt, active = args
        t, slot = bvh.pair_walk(tables.bvh(), tables.leaf_geo, o, d, maxt,
                                active, any_hit=q["kind"] == "any",
                                counts=counts)
        got = q["kernel"](*args, **kw)
        if q["kind"] == "any":
            differ += int((got != torch.isfinite(t)).sum())
        else:
            face = torch.where(slot >= 0, tables.leaf_face.long()[
                slot.clamp(min=0)], -1)
            differ += int(((got[0].view(torch.int32) != t.view(torch.int32))
                           | (got[1].long() != face)).sum())
    print(f"{name} pair walk (eager twin): {counts.get('record_visits', 0)} "
          f"record visits, {counts.get('tests', 0)} triangle tests; rays "
          f"where the kernel differs from the twin: {differ}")


def wavefront_phase(label, make, spp, names):
    """Phases 4 and 5: the wavefront PathIntegrator on ``make(256, 256)``
    at ``spp``, whose path must run exactly the hit queries ``names``.
    Returns their kernel rows."""
    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                                   render)
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import record_calls, wall_ms

    integ = PathIntegrator(max_depth=6, rr_depth=5)
    queries = hit_queries()

    def traced_sample(scene, spp):
        """integ.sample on the scene's primary rays, recording each hit
        query's calls."""
        ray, _, _, lane = sample_rays(scene, SEED, spp)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        with ExitStack() as stack:
            calls = {n: stack.enter_context(record_calls(scene_mod, n))
                     for n in names}
            L = integ.sample(scene, ray, lane, SEED, active)
        return L, (ray, lane, active), calls

    # ---- a. each kernel against its plain version, every call of a small
    # render (64x64 x 4: primary rays, then each depth's rays)
    _, _, calls = traced_sample(make(64, 64), 4)
    for n in names:
        for i, (args, kw) in enumerate(calls[n]):
            queries[n]["check"](f"{n} 64x64x4 call {i}",
                                queries[n]["kernel"](*args, **kw),
                                queries[n]["plain"](*args, **kw))
    if "intersect_packed" in names:
        tris, o, d = calls["intersect_packed"][0][0][:3]
        check_masks(tris, o, d)

    # ---- b. the main path, through the public entry point
    width = height = 256
    scene = make(width, height)
    n_lanes = width * height * spp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = require_launches(f"{label} render",
                                {n: 2 * integ.max_depth
                                 if n == "intersect_packed"
                                 else integ.max_depth for n in names})
    if "packet_closest_hit" in names:
        require_route(f"{label} render", "pair")
    print(f"{label} render {width}x{height}x{spp}: first {first_ms:.2f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # ---- c. per lane and image against the megakernel path
    L, (ray, lane, active), calls = traced_sample(scene, spp)
    mega = MegakernelPathIntegrator(integ.max_depth, integ.rr_depth)
    L_mega = mega.sample(scene, ray, lane, SEED, active)
    torch.cuda.synchronize()
    check_lanes(f"{label} PathIntegrator vs MegakernelPathIntegrator "
                f"{width}x{height}x{spp}", L, L_mega)
    check_image(f"{label} vs megakernel", image,
                render(scene, mega, seed=SEED, spp=spp), width, height)

    # ---- d. times
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 5)
    print(f"{label} render: {ms:.3f} ms, {n_lanes / ms * 1e3:.4e} rays/s")
    if "intersect_packed" in names:
        from mitsuba_tpu_torch.ops.intersect_packed import launch_config

        n_faces = int(calls["intersect_packed"][0][0][0].shape[1])
        print(f"intersect_packed grid at {n_lanes} rays: "
              f"{launch_config(n_faces, n_lanes)}")
    if "packet_closest_hit" in names:
        tables, o, d = calls["packet_closest_hit"][0][0][:3]
        walk_route = hit_grids(n_lanes, tables.depth)["closest"]["route"]
    rows = []
    for n in names:
        q = queries[n]
        kernel_ms, plain_ms, err, counts, nbytes, n_active, call_ms = \
            hold_calls(f"{n} {width}x{height}x{spp}", calls[n], q)
        ops = (counts.get("node_visits", 0) * OPS_PER_NODE_VISIT
               + counts["tests"] * OPS_PER_TRI_TEST)
        bound_ms, bound_by, t_ops, t_bytes = bound(ops, nbytes)
        print(f"{n}: {kernel_ms:.4f} ms over {len(calls[n])} launches, plain "
              f"{plain_ms:.2f} ms; node visits {counts.get('node_visits', 0)},"
              f" tests {counts['tests']} -> {ops:.4e} ops, {t_ops:.4f} ms; "
              f"active rays per call {n_active}; ms per call "
              f"{[round(x, 4) for x in call_ms]}; {nbytes} bytes -> "
              f"{t_bytes:.4f} ms")
        row = {"name": n, "route": "cuda",
               "source": f"mitsuba_tpu_torch/{q['source']}",
               "replaces": q["replaces"], "launches": launches[n],
               "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if n != "intersect_packed":
            pair_twin(n, q, calls[n])
            check_hit_schedule(n, q["kernel"], calls[n])
            row["walk_route"] = walk_route
        rows.append(row)
    if "packet_closest_hit" in names:
        check_hit_masks(tables, o, d)
    return rows


def fallback_phase():
    """Phase 6: a BVH scene with two area lights, outside the megakernel
    subset, through MegakernelPathIntegrator: it must fall back to the
    wavefront path and its BVH queries."""
    import dataclasses

    import torch

    from mitsuba_tpu_torch import MegakernelPathIntegrator, big_scene, render
    from mitsuba_tpu_torch.models.emitters import AreaEmitter
    from mitsuba_tpu_torch.models.scene import make_scene
    from mitsuba_tpu_torch.models.textures import ConstantTexture

    base = big_scene(64, 64)
    meshes = list(base.meshes)
    meshes[1] = dataclasses.replace(meshes[1], emitter_index=1)   # the floor
    glow = AreaEmitter(radiance=ConstantTexture(
        torch.tensor([0.5, 0.4, 0.3], device=base.device)))
    scene = make_scene(meshes, base.bsdfs, list(base.emitters) + [glow],
                       base.sensor, base.device)
    reset_counters()
    image = render(scene, MegakernelPathIntegrator(6, 5), seed=SEED, spp=4)
    torch.cuda.synchronize()
    require_launches("fallback two lights", {"packet_closest_hit": 6,
                                             "packet_any_hit": 6})
    if not bool(torch.isfinite(image).all()) or float(image.mean()) <= 0:
        raise AssertionError("fallback: bad image")
    print(f"fallback two lights 64x64x4: image mean {float(image.mean()):.6f}")

    # a tree deeper than the BVH kernels' walk takes: 1,000 triangles in
    # 40 nested clusters, each half the size of the one around it
    from mitsuba_tpu_torch import PathIntegrator, cornell_box
    from mitsuba_tpu_torch.models.shapes import Mesh
    from mitsuba_tpu_torch.ops.megakernel_bvh import STACK_CAP

    base = cornell_box(64, 64)
    g = torch.Generator().manual_seed(SEED)
    tris = []
    for k in range(40):
        c = torch.randn(25, 3, generator=g, dtype=torch.float64)
        c *= 0.3 * 0.5 ** k / c.norm(dim=1, keepdim=True)
        tris.append(c[:, None] + 0.003 * 0.5 ** k * torch.randn(
            25, 3, 3, generator=g, dtype=torch.float64))
    v = torch.cat(tris).reshape(-1, 3).float().numpy()
    cluster = Mesh.make(v, torch.arange(len(v)).reshape(-1, 3).numpy(),
                        bsdf_index=0, id="clusters", device=base.device)
    scene = make_scene(list(base.meshes) + [cluster], base.bsdfs,
                       base.emitters, base.sensor, base.device)
    if scene.accel.depth <= STACK_CAP:
        raise AssertionError(f"fallback: the nested clusters' tree is only "
                             f"{scene.accel.depth} deep")
    reset_counters()
    image = render(scene, MegakernelPathIntegrator(6, 5), seed=SEED, spp=4)
    torch.cuda.synchronize()
    label = f"fallback BVH {scene.accel.depth} deep (cap {STACK_CAP})"
    require_launches(label, {"packet_closest_hit": 6, "packet_any_hit": 6})
    require_route(label, "miss_link")
    n = 64 * 64 * 4
    if {g["route"] for g in hit_grids(n, scene.accel.depth).values()} \
            != {"miss_link"}:
        raise AssertionError(f"{label}: launch_config's route is not the "
                             "miss-link walk")
    same = torch.equal(image, render(scene, PathIntegrator(6, 5), seed=SEED,
                                     spp=4))
    print(f"fallback deep BVH 64x64x4: image mean {float(image.mean()):.6f}, "
          f"equal to the PathIntegrator's {same}")
    if not same or not bool(torch.isfinite(image).all()):
        raise AssertionError("fallback: the deep-tree image is not the "
                             "wavefront's")
    # the miss-link route's calls of that path against the plain versions
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import record_calls

    q = hit_queries()
    ray, _, _, lane = sample_rays(scene, SEED, 4)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    with ExitStack() as stack:
        calls = {name: stack.enter_context(record_calls(scene_mod, name))
                 for name in ("packet_closest_hit", "packet_any_hit")}
        PathIntegrator(6, 5).sample(scene, ray, lane, SEED, active)
    for name, recorded in calls.items():
        for i, (args, kw) in enumerate(recorded):
            q[name]["check"](f"{label} {name} call {i}",
                             q[name]["kernel"](*args, **kw),
                             q[name]["plain"](*args, **kw))


def config2_bsdfs(device, rough):
    """The small and the large box of BASELINE config 2: a Cu conductor
    and a dielectric of eta 1.5, smooth or GGX rough (alpha 0.2)."""
    import torch

    from mitsuba_tpu_torch.models.bsdfs import (CONDUCTOR_IOR, RoughConductor,
                                                RoughDielectric,
                                                SmoothConductor,
                                                SmoothDielectric)

    eta, k = (torch.tensor(x, device=device) for x in CONDUCTOR_IOR["Cu"])
    ior = torch.tensor(1.5, device=device)
    alpha = torch.tensor(0.2, device=device)
    if rough:
        return [RoughConductor(eta=eta, k=k, alpha=alpha),
                RoughDielectric(eta=ior, alpha=alpha)]
    return [SmoothConductor(eta=eta, k=k), SmoothDielectric(eta=ior)]


def config2_cornell(rough):
    """A factory (width, height, device) of the config-2 Cornell box: the
    boxes' BSDFs appended to the walls' (reference utils/scenes.py
    small_box_bsdf / large_box_bsdf)."""
    from mitsuba_tpu_torch import cornell_box
    from mitsuba_tpu_torch.models.scene import make_scene

    def make(width, height, device=None):
        base = cornell_box(width, height, small_box_bsdf=3, large_box_bsdf=4,
                           device=device)
        return make_scene(base.meshes, list(base.bsdfs) + config2_bsdfs(
            base.device, rough), base.emitters, base.sensor, base.device)
    return make


def config2_big_scene(width, height, device=None):
    """big_scene with the 81,920-triangle ball a GGX rough dielectric
    (eta 1.5, alpha 0.2) and the small box a smooth Cu conductor."""
    import dataclasses

    from mitsuba_tpu_torch import big_scene
    from mitsuba_tpu_torch.models.scene import make_scene

    base = big_scene(width, height, device=device)
    cond, _ = config2_bsdfs(base.device, rough=False)
    _, rdiel = config2_bsdfs(base.device, rough=True)
    meshes = list(base.meshes)
    n = len(base.bsdfs)
    meshes[-1] = dataclasses.replace(meshes[-1], bsdf_index=n)   # the ball
    meshes[6] = dataclasses.replace(meshes[6], bsdf_index=n + 1)  # small box
    return make_scene(meshes, list(base.bsdfs) + [rdiel, cond], base.emitters,
                      base.sensor, base.device)


def wavefront_check(label, scene, spp, integ, allowed, mega, mega_image):
    """A config-2 render through the wavefront ``integ`` (the
    PathIntegrator): it must launch only the kernels of ``allowed`` (name
    -> most launches); its lanes must hold the per-lane bar against the
    megakernel integrator ``mega`` on the same rays and its image the
    reference's 2e-2 against ``mega_image``.  Returns its render ms."""
    import torch

    from mitsuba_tpu_torch import render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    reset_counters()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    require_launches(f"{label} {type(integ).__name__} render", allowed)
    rel = float((image - mega_image).abs().mean() / mega_image.mean())
    print(f"{label} {type(integ).__name__} image vs megakernel: mean abs "
          f"rel diff {rel:.3e} (bound 2e-2)")
    if not bool(torch.isfinite(image).all()) or rel >= 2e-2:
        raise AssertionError(f"{label}: the wavefront and megakernel images "
                             "disagree")
    ray, _, _, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    check_lanes(f"{label} {type(integ).__name__} vs megakernel lanes",
                integ.sample(scene, ray, lane, SEED, active),
                mega.sample(scene, ray, lane, SEED, active))
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 3)
    print(f"{label} {type(integ).__name__} render: {ms:.3f} ms")
    return ms


def direct_check(label, make, spp):
    """The DirectIntegrator on ``make``'s scene: per lane against the same
    integrator over the plain hit queries on the CPU at 32x32 x 4, then
    at 256x256 x ``spp`` through intersect_packed alone (primary, shadow
    and BSDF rays).  Returns its render ms."""
    import torch

    from mitsuba_tpu_torch import DirectIntegrator, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    integ = DirectIntegrator()
    got, want = [], []
    for device, out in (("cuda", got), ("cpu", want)):
        scene = make(32, 32, device=device)
        ray, _, _, lane = sample_rays(scene, SEED, 4)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        out.append(integ.sample(scene, ray, lane, SEED, active).cpu())
    check_lanes(f"{label} DirectIntegrator card vs CPU 32x32x4", got[0],
                want[0])
    scene = make(256, 256)
    reset_counters()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    require_launches(f"{label} DirectIntegrator render",
                     {"intersect_packed": 3})
    if not bool(torch.isfinite(image).all()) or float(image.mean()) <= 0:
        raise AssertionError(f"{label}: bad DirectIntegrator image")
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 3)
    print(f"{label} DirectIntegrator render 256x256x{spp}: {ms:.3f} ms, "
          f"image mean {float(image.mean()):.6f}")
    return ms


def config2_phase(integ):
    """Phase 7: BASELINE config 2 (conductor and dielectric lobes) through
    the lobe builds of the three path kernels and the wavefront and
    direct integrators; returns the lobe builds' rows."""
    from mitsuba_tpu_torch import PathIntegrator

    rows = []
    wave = PathIntegrator(integ.max_depth, integ.rr_depth)
    for rough in (False, True):
        label = "config-2 cornell" + (" rough" if rough else "")
        make = config2_cornell(rough)
        row, mega_image, mega_ms = cornell_phase(integ, make, label)
        rows.append(row)
        scene = make(256, 256)
        wave_ms = wavefront_check(label, scene, 64, wave,
                                  {"intersect_packed": 2 * wave.max_depth},
                                  integ, mega_image)
        direct_ms = direct_check(label, make, 64)
        print(f"{label} renders 256x256x64: megakernel {mega_ms:.3f} ms, "
              f"path {wave_ms:.3f} ms, direct {direct_ms:.3f} ms")
    label = "config-2 big_scene"
    bvh_rows, mega_image, mega_ms = bvh_phase(integ, config2_big_scene, label)
    rows += bvh_rows
    wave_ms = wavefront_check(label, config2_big_scene(256, 256), 16, wave,
                              {"packet_closest_hit": wave.max_depth,
                               "packet_any_hit": wave.max_depth},
                              integ, mega_image)
    print(f"{label} renders 256x256x16: megakernel sorted "
          f"{mega_ms['sorted']:.3f} ms, unsorted {mega_ms['unsorted']:.3f} "
          f"ms, path {wave_ms:.3f} ms")
    return rows


def surfaces_phase(integ):
    """Phase 8: plastic, two-sided and bitmap-textured surfaces (BSDF
    codes 5-7 and +16) through the surface builds of the path kernels and
    the wavefront PathIntegrator; returns the surface builds' rows."""
    import dataclasses
    import functools

    from mitsuba_tpu_torch import PathIntegrator
    from mitsuba_tpu_torch.utils.scenes import (plastic_cornell,
                                                surfaces_big_scene,
                                                textured_cornell,
                                                twosided_cornell)

    rows = []
    wave = PathIntegrator(integ.max_depth, integ.rr_depth)
    # no fallback: a scene the kernels refuse raises instead
    integ = dataclasses.replace(integ, strict=True)
    for label, make in (
            ("plastic cornell", plastic_cornell),
            ("two-sided cornell", twosided_cornell),
            ("textured cornell", functools.partial(textured_cornell,
                                                   seed=SEED))):
        row, mega_image, mega_ms = cornell_phase(integ, make, label)
        rows.append(row)
        wave_ms = wavefront_check(label, make(256, 256), 64, wave,
                                  {"intersect_packed": 2 * wave.max_depth},
                                  integ, mega_image)
        print(f"{label} renders 256x256x64: megakernel {mega_ms:.3f} ms, "
              f"path {wave_ms:.3f} ms")
    bvh_walks = {"packet_closest_hit": wave.max_depth,
                 "packet_any_hit": wave.max_depth}
    for label, make, single in (
            ("surfaces big_scene", surfaces_big_scene, True),
            ("textured big_scene", functools.partial(
                surfaces_big_scene, textured=True, seed=SEED), False)):
        bvh_rows, mega_image, mega_ms = bvh_phase(integ, make, label,
                                                  single_launch=single)
        rows += bvh_rows
        wave_ms = wavefront_check(label, make(256, 256), 16, wave, bvh_walks,
                                  integ, mega_image)
        print(f"{label} renders 256x256x16: megakernel {mega_ms}, path "
              f"{wave_ms:.3f} ms")
    build_split_check(integ)
    return rows


def envmap_phase(integ):
    """Phase 9: environment-map lighting through the environment builds of
    megakernel_trace and megakernel_bounce_bvh and the wavefront and direct
    integrators; returns the environment builds' rows and the phase's
    seconds."""
    import dataclasses
    import functools

    from mitsuba_tpu_torch import PathIntegrator
    from mitsuba_tpu_torch.utils.scenes import (envmap_big_scene, envmap_scene,
                                                sky_envmap)

    t0 = time.perf_counter()
    sky = sky_envmap(seed=SEED)   # made once; every scene takes a copy
    rows = []
    wave = PathIntegrator(integ.max_depth, integ.rr_depth)
    # no fallback: a scene the kernels refuse raises instead
    integ = dataclasses.replace(integ, strict=True)
    for label, area in (("envmap scene", False), ("envmap+area scene", True)):
        make = functools.partial(envmap_scene, area_light=area, env=sky)
        row, mega_image, mega_ms = cornell_phase(integ, make, label,
                                                 plain_reps=1)
        rows.append(row)
        wave_ms = wavefront_check(label, make(256, 256), 64, wave,
                                  {"intersect_packed": 2 * wave.max_depth},
                                  integ, mega_image)
        direct_ms = direct_check(label, make, 64)
        print(f"{label} renders 256x256x64: megakernel {mega_ms:.3f} ms, "
              f"path {wave_ms:.3f} ms, direct {direct_ms:.3f} ms")
    label = "envmap big_scene"
    make = functools.partial(envmap_big_scene, env=sky)
    bvh_rows, mega_image, mega_ms = bvh_phase(integ, make, label,
                                              single_launch=False)
    rows += bvh_rows
    wave_ms = wavefront_check(label, make(256, 256), 16, wave,
                              {"packet_closest_hit": wave.max_depth,
                               "packet_any_hit": wave.max_depth},
                              integ, mega_image)
    print(f"{label} renders 256x256x16: megakernel {mega_ms}, path "
          f"{wave_ms:.3f} ms")
    return rows, time.perf_counter() - t0


def build_split_check(integ):
    """What merging the lobe build into the surface build would cost: the
    config-2 scenes' kernels run as they do (the lobe build) and through
    the surface build (a code it alone takes, 6, added to btypes; no face
    carries it), in turns (lobe, surface, surface, lobe), CUDA-event
    medians of 5 each; every lane must be the same bits."""
    import torch

    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.megakernel import (megakernel_trace,
                                                  pack_scene, scene_btypes)
    from mitsuba_tpu_torch.ops.megakernel_bvh import (megakernel_trace_bvh,
                                                      pack_scene_bvh)
    from mitsuba_tpu_torch.utils.profile_path import events_ms

    def launches(scene, spp):
        ray, _, _, lane = sample_rays(scene, SEED, spp)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        depth_kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth)
        bt = scene_btypes(scene)
        if scene.accel is None:
            tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
            return lambda btypes: megakernel_trace(
                tris, light, lane, ray.o, ray.d, active, SEED, **depth_kw,
                n_faces=n_faces, n_lights=n_lights, btypes=btypes), bt
        tables = pack_scene_bvh(scene)
        return lambda btypes: megakernel_trace_bvh(
            tables, lane, ray.o, ray.d, active, SEED, **depth_kw,
            smooth=True, btypes=btypes), bt

    for label, scene, spp in (
            ("megakernel_trace config-2 cornell", config2_cornell(False)(
                256, 256), 64),
            ("megakernel_trace config-2 cornell rough", config2_cornell(True)(
                256, 256), 64),
            ("megakernel_trace_bvh config-2 big_scene",
             config2_big_scene(256, 256), 16)):
        run, bt = launches(scene, spp)
        surface_bt = tuple(sorted(set(bt) | {6}))
        same = same_bits(run(bt), run(surface_bt))
        ms = {}
        for b in (bt, surface_bt, surface_bt, bt):
            ms.setdefault(b, []).append(events_ms(lambda: run(b), 5))
        print(f"build split {label} {bt}: lobe build "
              f"{ms[bt][0]:.4f} / {ms[bt][1]:.4f} ms, surface build "
              f"{ms[surface_bt][0]:.4f} / {ms[surface_bt][1]:.4f} ms, "
              f"lanes bitwise equal {same}")
        if not same:
            raise AssertionError(f"build split {label}: the surface build "
                                 "changed a lane")


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


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
    from mitsuba_tpu_torch import MegakernelPathIntegrator

    print(gpu_line())
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_all()
    integ = MegakernelPathIntegrator(max_depth=6, rr_depth=5)
    from mitsuba_tpu_torch import big_scene, cornell_box

    kernels = [cornell_phase(integ)[0], *bvh_phase(integ)[0]]
    kernels += wavefront_phase("cornell wavefront", cornell_box, 64,
                               ["intersect_packed"])
    kernels += wavefront_phase("big_scene wavefront", big_scene, 16,
                               ["packet_closest_hit", "packet_any_hit"])
    fallback_phase()
    kernels += config2_phase(integ)
    kernels += surfaces_phase(integ)
    env_rows, env_s = envmap_phase(integ)
    kernels += env_rows
    print(f"phase 9 (environment maps): {env_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
