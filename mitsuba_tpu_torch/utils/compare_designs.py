"""Time this checkout's kernels against an earlier checkout's designs, in
one process on one GPU.

    python -m mitsuba_tpu_torch.utils.compare_designs --other DIR \
        [--phases idle,intersect,megakernel,bvh_trace,bvh_bounce,bvh_divergence,hits]
    python -m mitsuba_tpu_torch.utils.compare_designs \
        --phases bvh_divergence,laplacian,gather,splat

``DIR`` is the root of an earlier checkout, for example a ``git archive``
of that commit unpacked into the ignored ``_tree/``.  Its native sources
are built with its own ``ops/_build.py`` into its own ``_build/`` and
called through the C interfaces this tool knows, those of the
one-thread-a-lane designs:

    intersect_packed(tris, n_faces, o, d, maxt, active, n,
                     t, prim, u, v, stream)
    megakernel_trace(tris, n_faces, light, n_lights, lanes, o, d, active,
                     seed, max_depth, rr_depth, smooth, n, out, stream)
    megakernel_bounce_bvh(node_box, node_meta, leaf_geo, leaf_face, tris,
                          light, n_lights, lanes, state, n, seed, depth,
                          max_depth, rr_depth, smooth, stream)
    megakernel_trace_bvh(node_box, node_meta, leaf_geo, leaf_face, tris,
                         light, n_lights, lanes, o, d, active, seed,
                         max_depth, rr_depth, smooth, n, out, stream)
    packet_closest_hit(node_box, node_meta, leaf_geo, leaf_face, o, d,
                       maxt, active, n, t, face, stream)
    packet_any_hit(node_box, node_meta, leaf_geo, leaf_face, o, d, maxt,
                   active, n, occluded, stream)

It refuses a checkout whose library exports ``intersect_packed_config``,
``megakernel_trace_config`` or ``megakernel_trace_bvh_config``, as the
persistent-grid designs do; a phase loads only the library it needs.  The
hit queries are called through the interface above, or, where the other
library exports ``packet_hit_config`` (a persistent grid: a later design
of this file's), through the one ``ops/traverse.py`` calls, with the
tree's ``node_pair`` and depth and a zeroed counter.

The brute-force phases run BASELINE config 1: ``cornell_box(256, 256)``,
64 spp; the BVH phases ``big_scene(256, 256)`` (81,956 triangles), 16
spp, smooth normals; all at max_depth 6, rr_depth 5, seed 7.  Kernel
times are ``profile_path.events_ms`` (CUDA-event medians of 5), each call
timed alone and summed over a frame's launches, in turns: other, this,
this, other, twice over (the card's first seconds under load run slower,
so each design gets early and late turns alike).

- ``idle``: the other checkout's ``intersect_packed`` on the 12 calls of
  the wavefront ``PathIntegrator`` (recorded through that kernel), as
  they are and with each call's active rays moved in front of the
  inactive ones (a stable sort by the mask).  Same tests, fewer thread
  slots: the gap between the two sums is the time that threads holding
  inactive slots cost.  The packed outputs must equal the unpacked ones
  bit for bit.
- ``intersect``: both ``intersect_packed`` on the same calls, in turns;
  every output of every call must be equal
  bit for bit.
- ``megakernel``: both ``megakernel_trace`` on the frame's primary rays,
  in turns; the radiance of every lane must be
  equal bit for bit.
- ``bvh_trace``: both ``megakernel_trace_bvh`` on the frame's primary
  rays in Morton order (as ``sort_bounces=False`` launches it), in turns;
  every lane's radiance bit for bit.
- ``bvh_bounce``: both ``megakernel_bounce_bvh`` on each of the six
  states that the default sorted pipeline launches it on
  (``profile_path.record_bounces``), in turns, summed over the frame;
  every state out bit for bit.
- ``bvh_divergence``: from the plain versions' counts (no kernel): the
  path-length lane use of a one-thread-a-lane ``megakernel_trace_bvh``,
  Σ bounces / (32 × Σ per-warp most bounces) over warps of 32 lanes in
  Morton order; and for each depth of the sorted pipeline the walk's
  SIMD efficiency over the warps of that depth's launch, Σ visits / (32 ×
  Σ per-warp most visits), for the closest and the shadow walk (node
  visits, and triangle tests).
- ``hits``: the other checkout's one-thread-a-ray miss-link
  ``packet_closest_hit`` and ``packet_any_hit`` against this checkout's
  (active-ray compaction in a persistent grid, the two-child walk on the
  route of the tree's depth) on the 12 calls of the wavefront
  ``PathIntegrator``'s at-scale frame (6 closest, 6 shadow; recorded
  through the other's kernels), and this checkout's kernels forced onto
  the miss-link route (the tree's depth set past the pair walk's stack),
  which parts the grid's gain from the walk's; in turns: other, this,
  miss-link, miss-link, this, other, twice over.  Occluded must be equal
  on every ray; the rays whose (t, face) differ from the other's are
  counted and printed (0 expected).  Prints each call's active rays and
  each design's per-call ms (the median of its turns), which show where
  the frame's time goes: the dense first depth against the sparse late
  ones.

Prints the card's name and power limit, then one JSON line a phase.
Fails without a GPU and on any disagreement.
- ``laplacian`` (no other checkout needed): LargeSteps' Laplacian
  product on ``big_scene``'s ball as this checkout computes it (a
  neighbour gather summed in a fixed order) against the edge scatter it
  replaced (two ``index_add`` over the edges, atomics on the card), and
  a CG round trip by each, in turns; with the scatter also under
  ``torch.use_deterministic_algorithms``.  Reports each product's ms
  (CUDA events, median of 20), each round trip's ms (host clock, median
  of 3), the CG iterations of a solve and whether each product repeats
  bit for bit.  A geometry step makes two solves (the vertices and
  their gradient), so the gather's cost a step is twice the iterations
  times the products' difference.
- ``gather`` (no other checkout needed): the scene's row gathers as this
  checkout makes them (``ops/gather.py::gather_rows``, whose backward
  adds each row's lanes in a fixed order) against ``index_select`` (an
  atomic ``index_add`` backward on the card), on two steps of
  ``chip_smoke.py``: phase 10's config-3 PRB step (``textured_cornell(256,
  256)``, 16 spp, the gradient of a weighted image sum with respect to a
  texture and an albedo) and 13b's geometry step (``big_scene(256, 256)``,
  16 spp, the ball's vertices through LargeSteps and
  ``prb_projective_render``, sppp 4096, n_sub 4), in turns.  Reports each
  step's ms (host clock, median of 3 a turn) and whether PRB's adjoint
  (``prb._adjoint`` on the geometry step's scene and a fixed adjoint
  image) repeats bit for bit under each gather.
- ``splat`` (no other checkout needed): the film's ``splat``, the
  particle tracer's scatter of its sensor connections, as this checkout
  makes it (``ops/gather.py::index_add_rows``, a fixed-point sum by
  integer atomics on the card) against the float ``index_add`` it
  replaced and against ``segment_sum``, on ``chip_smoke.py`` phase 11b's
  doublet design step and on that step's recorded splat calls alone, in
  turns; whether the step's gradient repeats bit for bit under each.  (The boundary and shadow passes of a projective step
  splat nothing: they read the adjoint image through
  ``projective._film_adjoint``.)
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import torch

from .. import MegakernelPathIntegrator, PathIntegrator, big_scene, cornell_box
from ..core import rng
from ..models import scene as scene_mod
from ..models.integrators import megapath, sample_rays
from ..ops import intersect_packed as ip
from ..ops import megakernel as mk
from ..ops import megakernel_bvh as mkb
from ..ops import traverse as tv
from .largesteps import LargeSteps
from .profile_path import events_ms, record_bounces, wall_ms

SIZE = 256
SPP = 64
BVH_SPP = 16
SEED = 7
MAX_DEPTH = 6
RR_DEPTH = 5


class OtherKernels:
    """The other checkout's kernels, through ctypes; each library is built
    and loaded at its first use."""

    def __init__(self, root: Path):
        path = root / "mitsuba_tpu_torch" / "ops" / "_build.py"
        spec = importlib.util.spec_from_file_location("other_build", path)
        self._build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self._build)
        self._root = root
        self._entries = {}

    def _entry(self, source, name, config, argtypes):
        """``name`` of the other checkout's library ``source``, refused if
        that library exports ``config`` (a persistent-grid interface)."""
        if name not in self._entries:
            lib = self._build.load(source)
            if hasattr(lib, config):
                raise SystemExit(f"compare_designs: {self._root}'s {source} "
                                 f"exports {config}, a persistent-grid "
                                 "interface this tool does not know")
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._entries[name] = fn
        return self._entries[name]

    def intersect(self, tris, o, d, maxt, active):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = self._entry("intersect_packed", "intersect_packed",
                         "intersect_packed_config",
                         [p, i, p, p, p, p, i, p, p, p, p, p])
        n = int(o.shape[0])
        dev = o.device
        t = torch.empty(n, dtype=torch.float32, device=dev)
        prim = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        rc = fn(tris.data_ptr(), int(tris.shape[1]), o.data_ptr(),
                d.data_ptr(), maxt.data_ptr(), active.data_ptr(), n,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other intersect_packed: CUDA error {rc}")
        return t, prim, u, v

    def trace(self, tris, light, lane, o, d, active, seed, n_faces,
              n_lights):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = self._entry("megakernel", "megakernel_trace",
                         "megakernel_trace_config",
                         [p, i, p, i, p, p, p, p, ctypes.c_uint32, i, i, i,
                          i, p, p])
        n = int(o.shape[0])
        out = torch.empty((n, 3), dtype=torch.float32, device=o.device)
        rc = fn(tris.data_ptr(), n_faces, light.data_ptr(), n_lights,
                lane.data_ptr(), o.data_ptr(), d.data_ptr(),
                active.data_ptr(), int(seed) & rng.MASK32, MAX_DEPTH,
                RR_DEPTH, 0, n, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other megakernel_trace: CUDA error {rc}")
        return out

    def _bvh(self, name, argtypes):
        return self._entry("megakernel_bvh", name,
                           "megakernel_trace_bvh_config", argtypes)

    def trace_bvh(self, tables, lane, o, d, active, seed):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn = self._bvh("megakernel_trace_bvh",
                       [p, p, p, p, p, p, i, p, p, p, p, u, i, i, i, i, p, p])
        n = int(o.shape[0])
        out = torch.empty((n, 3), dtype=torch.float32, device=o.device)
        rc = fn(*_geometry_ptrs(tables), lane.data_ptr(), o.data_ptr(),
                d.data_ptr(), active.data_ptr(), int(seed) & rng.MASK32,
                MAX_DEPTH, RR_DEPTH, 1, n, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other megakernel_trace_bvh: CUDA error {rc}")
        return out

    def bounce_bvh(self, tables, lane, seed, state, depth):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn = self._bvh("megakernel_bounce_bvh",
                       [p, p, p, p, p, p, i, p, p, i, u, i, i, i, i, p])
        rc = fn(*_geometry_ptrs(tables), lane.data_ptr(), state.data_ptr(),
                int(state.shape[1]), int(seed) & rng.MASK32, depth,
                MAX_DEPTH, RR_DEPTH, 1, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other megakernel_bounce_bvh: CUDA error {rc}")
        return state


    def _hit(self, name, outs, tables, o, d, maxt, active):
        """The other checkout's hit query ``name`` into ``outs``: through
        the one-thread-a-ray interface, or through the persistent-grid one
        (node_pair, the tree's depth and a counter besides) where its
        library exports ``packet_hit_config``."""
        if name not in self._entries:
            lib = self._build.load("traverse")
            grid = hasattr(lib, "packet_hit_config")
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = getattr(lib, name)
            fn.argtypes = ([p] * 5 + [i] if grid else [p] * 4) + [p] * 4 \
                + [i] + [p] * len(outs) + ([p] if grid else []) + [p]
            fn.restype = ctypes.c_int
            self._entries[name] = fn, grid
        fn, grid = self._entries[name]
        n = int(o.shape[0])
        rays = (o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
                active.data_ptr(), n, *(x.data_ptr() for x in outs))
        stream = torch.cuda.current_stream().cuda_stream
        if grid:
            counter = torch.zeros(1, dtype=torch.int32, device=o.device)
            rc = fn(tables.node_box.data_ptr(), tables.node_meta.data_ptr(),
                    tables.node_pair.data_ptr(), tables.leaf_geo.data_ptr(),
                    tables.leaf_face.data_ptr(), tables.depth, *rays,
                    counter.data_ptr(), stream)
        else:
            rc = fn(*(x.data_ptr() for x in tables.tensors()), *rays, stream)
        if rc != 0:
            raise RuntimeError(f"other {name}: CUDA error {rc}")
        return outs

    def closest_hit(self, tables, o, d, maxt, active):
        n = int(o.shape[0])
        return self._hit("packet_closest_hit",
                         (torch.empty(n, dtype=torch.float32, device=o.device),
                          torch.empty(n, dtype=torch.int32, device=o.device)),
                         tables, o, d, maxt, active)

    def any_hit(self, tables, o, d, maxt, active):
        n = int(o.shape[0])
        return self._hit("packet_any_hit",
                         (torch.empty(n, dtype=torch.bool, device=o.device),),
                         tables, o, d, maxt, active)[0]


def _geometry_ptrs(t):
    """The one-thread-a-lane BVH kernels' table arguments."""
    return (*(x.data_ptr() for x in t.tensors()), t.tris.data_ptr(),
            t.light.data_ptr(), t.n_lights)


def require_equal(label, got, ref):
    """Every tensor of ``got`` equal to ``ref``'s bit for bit."""
    for a, b in zip(got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: outputs differ")


def frame_calls(other, scene):
    """The wavefront PathIntegrator's intersect_packed calls on the frame,
    made through the other checkout's kernel: [(tris, o, d, maxt, active)]."""
    calls = []

    def recording(tris, o, d, maxt, active):
        calls.append((tris, o, d, maxt, active))
        return other.intersect(tris, o, d, maxt, active)

    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    own = scene_mod.intersect_packed
    scene_mod.intersect_packed = recording
    try:
        PathIntegrator(MAX_DEPTH, RR_DEPTH).sample(scene, ray, lane, SEED,
                                                   active)
    finally:
        scene_mod.intersect_packed = own
    torch.cuda.synchronize()
    return calls


def frame_ms(fn, calls):
    """(the frame's sum, each call's CUDA-event median of 5) of ``fn``."""
    ms = [events_ms(lambda: fn(*c), 5) for c in calls]
    return sum(ms), ms


# the order of the turns: a, b, b, a, twice over
TURNS = (0, 1, 1, 0, 0, 1, 1, 0)


def in_turns(designs, calls):
    """Each design's frame ms in each of its turns."""
    names = list(designs)
    times = {name: [] for name in names}
    for k in TURNS:
        times[names[k]].append(frame_ms(designs[names[k]], calls)[0])
    return times


def idle_phase(other, calls):
    packed = []
    for c in calls:
        perm = torch.argsort((~c[4]).to(torch.int8), stable=True)
        packed.append((c[0], *(x[perm] for x in c[1:])))
        require_equal("idle: packed call", other.intersect(*packed[-1]),
                      [x[perm] for x in other.intersect(*c)])
    as_is, as_is_calls = frame_ms(other.intersect, calls)
    front, front_calls = frame_ms(other.intersect, packed)
    return {"phase": "idle",
            "active_rays": [int(c[4].sum()) for c in calls],
            "ray_slots": [int(c[4].shape[0]) for c in calls],
            "as_is_ms": as_is, "as_is_calls_ms": as_is_calls,
            "packed_ms": front, "packed_calls_ms": front_calls,
            "idle_share": 1.0 - front / as_is}


def intersect_phase(other, calls):
    for i, c in enumerate(calls):
        require_equal(f"intersect: call {i}", ip.intersect_packed(*c),
                      other.intersect(*c))
    n = int(calls[0][1].shape[0])
    return {"phase": "intersect", "bitwise_equal": True,
            "frame_ms": in_turns({"other": other.intersect,
                                  "this": ip.intersect_packed}, calls),
            "launch_config": ip.launch_config(int(calls[0][0].shape[1]), n)}


def megakernel_phase(other, scene):
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    tris, light, n_faces, n_lights, _, _ = mk.pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, SEED)

    def this():
        return mk.megakernel_trace(*args, max_depth=MAX_DEPTH,
                                   rr_depth=RR_DEPTH, n_faces=n_faces,
                                   n_lights=n_lights)

    def theirs():
        return other.trace(*args, n_faces, n_lights)

    ref = theirs()
    got = this()
    torch.cuda.synchronize()
    lanes_differ = int((got != ref).any(dim=-1).sum())
    result = {"phase": "megakernel", "lanes": int(lane.shape[0]),
              "bitwise_equal": torch.equal(got, ref),
              "lanes_differ": lanes_differ,
              "ms": in_turns({"other": theirs, "this": this}, [()]),
              "launch_config": mk.launch_config(n_faces, n_lights,
                                                int(lane.shape[0]))}
    if not result["bitwise_equal"]:
        print(json.dumps(result))
        raise AssertionError("megakernel: radiance differs from the other "
                             "checkout's")
    return result


BVH_KW = dict(max_depth=MAX_DEPTH, rr_depth=RR_DEPTH, smooth=True)


def same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def bvh_inputs(scene):
    """(tables, rays, lane ids, all-active mask) of the at-scale frame."""
    ray, _, _, lane = sample_rays(scene, SEED, BVH_SPP)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    return mkb.pack_scene_bvh(scene), ray, lane, active


def bvh_trace_phase(other, scene):
    tables, ray, lane, active = bvh_inputs(scene)
    n = int(lane.shape[0])
    p = torch.as_tensor(megapath._morton_perm(SIZE, SIZE, n),
                        device=lane.device)
    args = (tables, lane[p], ray.o[p], ray.d[p], active[p], SEED)

    def this():
        return mkb.megakernel_trace_bvh(*args, **BVH_KW)

    def theirs():
        return other.trace_bvh(*args)

    ref = theirs()
    got = this()
    torch.cuda.synchronize()
    differ = (got.view(torch.int32) != ref.view(torch.int32)).any(dim=-1)
    result = {"phase": "bvh_trace", "lanes": n,
              "bitwise_equal": same_bits(got, ref),
              "lanes_differ": int(differ.sum()),
              "ms": in_turns({"other": theirs, "this": this}, [()]),
              "launch_config": mkb.launch_config("trace", n),
              "tree_depth": tables.depth}
    if not result["bitwise_equal"]:
        print(json.dumps(result))
        raise AssertionError("bvh_trace: radiance differs from the other "
                             "checkout's")
    return result


def bvh_bounce_phase(other, scene):
    tables, ray, lane, active = bvh_inputs(scene)
    integ = MegakernelPathIntegrator(MAX_DEPTH, RR_DEPTH)
    _, recorded = record_bounces(integ, scene, ray, lane, SEED, active)
    designs = {
        "other": lambda rl, st, depth: other.bounce_bvh(tables, rl, SEED, st,
                                                        depth),
        "this": lambda rl, st, depth: mkb.megakernel_bounce_bvh(
            tables, rl, SEED, st, depth, **BVH_KW)}
    differ = []
    for rlane, s_in, s_out, depth in recorded:
        got = designs["other"](rlane, s_in.clone(), depth)
        torch.cuda.synchronize()
        differ.append(int((got.view(torch.int32)
                           != s_out.view(torch.int32)).any(dim=0).sum()))
    names = list(designs)
    depth_ms = {name: [] for name in names}
    for k in TURNS:
        fn = designs[names[k]]
        depth_ms[names[k]].append([
            events_ms(lambda st: fn(rlane, st, depth), 5, setup=s_in.clone)
            for rlane, s_in, _, depth in recorded])
    n = int(lane.shape[0])
    result = {"phase": "bvh_bounce", "lanes": n,
              "live_lanes": [int((s[15] > 0.5).sum()) for _, s, _, _ in
                             recorded],
              "bitwise_equal": not any(differ), "lanes_differ": differ,
              "ms": {k: [sum(t) for t in v] for k, v in depth_ms.items()},
              "depth_ms": depth_ms,
              "launch_config": mkb.launch_config("bounce", n),
              "tree_depth": tables.depth}
    if not result["bitwise_equal"]:
        print(json.dumps(result))
        raise AssertionError("bvh_bounce: a state differs from the other "
                             "checkout's")
    return result


def warp_use(x):
    """Σ x / (32 × Σ per-warp max x) over warps of 32 consecutive lanes;
    None when every lane is 0."""
    x = torch.nn.functional.pad(x, (0, -x.shape[0] % 32)).view(-1, 32)
    most = int(x.max(dim=1).values.sum())
    return int(x.sum()) / (32 * most) if most else None


def bvh_divergence_phase(scene):
    tables, ray, lane, active = bvh_inputs(scene)
    n = int(lane.shape[0])
    p = torch.as_tensor(megapath._morton_perm(SIZE, SIZE, n),
                        device=lane.device)
    state = mkb.primary_state(ray.o[p], ray.d[p], active[p])
    lane_p = lane[p]
    bounces = torch.zeros(n, dtype=torch.int64, device=lane.device)
    for depth in range(MAX_DEPTH):
        live = state[15] > 0.5
        bounces += live
        state = mkb.megakernel_bounce_bvh_plain(tables, lane_p, SEED, state,
                                                depth, **BVH_KW)
    integ = MegakernelPathIntegrator(MAX_DEPTH, RR_DEPTH)
    _, recorded = record_bounces(integ, scene, ray, lane, SEED, active)
    depths = []
    for rlane, s_in, _, depth in recorded:
        counts = {}
        mkb.megakernel_bounce_bvh_plain(tables, rlane, SEED, s_in, depth,
                                        **BVH_KW, counts=counts)
        row = {"depth": depth, "live_lanes": int((s_in[15] > 0.5).sum())}
        for walk, key in (("closest", "closest_tests"),
                          ("shadow", "shadow_tests")):
            per_lane = counts["per_lane"][key]
            row[f"{walk}_visit_use"] = warp_use(per_lane["node_visits"])
            row[f"{walk}_test_use"] = warp_use(per_lane["tests"])
            row[f"{walk}_node_visits"] = int(per_lane["node_visits"].sum())
        depths.append(row)
    return {"phase": "bvh_divergence", "lanes": n,
            "bounces": int(bounces.sum()),
            "path_length_lane_use": warp_use(bounces),
            "sorted_depths": depths}


def laplacian_phase(scene):
    ball = scene.meshes[8]
    ls = LargeSteps(ball.vertices, ball.faces, device=scene.device)
    u = ls.to_differential(ball.vertices)
    nbr = ls.neighbours
    n = nbr.shape[0]
    rows = torch.arange(n, device=nbr.device)[:, None].expand_as(nbr)
    pair = (nbr < n) & (rows < nbr)
    ea, eb = rows[pair], nbr[pair]

    def scatter(x):
        ax = (torch.zeros_like(x).index_add(0, ea, x[eb])
              .index_add(0, eb, x[ea]))
        return x + ls.lambda_ * (ls.degree[:, None] * x - ax)

    def gather(x):
        return LargeSteps._laplacian_matvec(ls, x)

    designs = {"gather": gather, "scatter": scatter}
    product = {name: [] for name in designs}
    solve = {name: [] for name in designs}
    for k in TURNS:
        name = list(designs)[k]
        ls._laplacian_matvec = designs[name]
        product[name].append(events_ms(lambda: ls._laplacian_matvec(u), 20))
        solve[name].append(wall_ms(lambda: ls.from_differential(u), 3))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ls._laplacian_matvec = scatter
        deterministic_ms = wall_ms(lambda: ls.from_differential(u), 3)
        repeats_det = same_bits(scatter(u), scatter(u))
    finally:
        torch.use_deterministic_algorithms(False)
    ls._laplacian_matvec = gather
    ls.from_differential(u)
    return {"phase": "laplacian", "vertices": n, "edges": ls.n_edges,
            "cg_iterations": ls.iterations,
            "product_ms": product, "solve_ms": solve,
            "scatter_deterministic_solve_ms": deterministic_ms,
            "repeats": {"gather": same_bits(gather(u), gather(u)),
                        "scatter": same_bits(scatter(u), scatter(u)),
                        "scatter_deterministic": repeats_det}}


def gather_phase():
    from .. import (PathProjectiveIntegrator, PRBIntegrator,
                    build_silhouette_edges, prb_projective_render,
                    prb_render)
    from ..models.integrators import prb
    from .params import traverse, update
    from .scenes import textured_cornell

    def plain(x, index):
        return x.index_select(0, index)

    designs = {"gather_rows": scene_mod.gather_rows, "index_select": plain}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tex_scene = textured_cornell(SIZE, SIZE, seed=SEED)
    tex = f"bsdfs.{tex_scene.meshes[3].bsdf_index}.reflectance.data"
    alb = "bsdfs.2.reflectance.value"
    w = torch.rand((SIZE, SIZE, 3), generator=gen, device="cuda")
    integ = PRBIntegrator(MAX_DEPTH, RR_DEPTH)

    def config3_step():
        leaves = {k: traverse(tex_scene)[k].clone().requires_grad_()
                  for k in (tex, alb)}
        torch.sum(prb_render(update(tex_scene, leaves), integ, SEED, BVH_SPP)
                  * w).backward()

    big = big_scene(SIZE, SIZE)
    key = "meshes.8.vertices"
    v0 = traverse(big)[key]
    ls = LargeSteps(v0, big.meshes[8].faces, device=big.device)
    u = ls.to_differential(v0 + torch.tensor([0.05, 0.0, 0.0],
                                             device="cuda"))
    edges = build_silhouette_edges(big)
    pinteg = PathProjectiveIntegrator(MAX_DEPTH, RR_DEPTH, sppp=4096, n_sub=4)
    with torch.no_grad():
        target = prb_projective_render(big, edges, pinteg, SEED, BVH_SPP)

    def geometry_step():
        leaf = u.clone().requires_grad_()
        img = prb_projective_render(update(big, {key: ls.from_differential(
            leaf)}), edges, pinteg, SEED, BVH_SPP)
        torch.mean((img - target) ** 2).backward()

    adjoint = torch.rand(target.shape, generator=gen, device="cuda") * 1e-3
    det = prb._detached(big)

    def adjoint_grad():
        return prb._adjoint(det, pinteg._prb(), SEED, BVH_SPP, adjoint,
                            {key: v0})[key]

    steps = {"config3_step": config3_step, "geometry_step": geometry_step}
    ms = {s: {d: [] for d in designs} for s in steps}
    repeats = {}
    try:
        for name in designs:      # warm both up, and the repeat check
            scene_mod.gather_rows = designs[name]
            for fn in steps.values():
                fn()
            repeats[name] = same_bits(adjoint_grad(), adjoint_grad())
        for k in TURNS:
            name = list(designs)[k]
            scene_mod.gather_rows = designs[name]
            for s_name, fn in steps.items():
                ms[s_name][name].append(wall_ms(fn, 3))
    finally:
        scene_mod.gather_rows = designs["gather_rows"]
    return {"phase": "gather", "step_ms": ms,
            "median_ms": {s: {d: statistics.median(v) for d, v in x.items()}
                          for s, x in ms.items()},
            "adjoint_repeats": repeats}


def splat_phase():
    """The film's ``splat`` as this checkout makes it (``index_add_rows``:
    a fixed-point sum by integer atomics on the card) against the float
    ``index_add`` it replaced (atomic adds, whose order changes the bits)
    and against ``segment_sum`` (a sort, then block sums in a fixed
    order: the backward of ``gather_rows``), on the config-5 doublet
    design step of ``chip_smoke.py`` phase 11b (24 x 24, 2048 light paths
    a pixel, the gradient of the loss), the particle tracer's only
    splat; and on the step's recorded splat calls alone (CUDA events,
    median of 5 a call, summed).  In turns; whether the loss's gradient
    repeats bit for bit under each."""
    from ..examples.doublet_achromat_design import build_doublet, make_problem
    from ..lens.design import value_and_grad
    from ..models import film as film_mod
    from ..ops.gather import segment_sum
    from .profile_path import record_calls

    def plain(base, index, values):
        return base.index_add(0, index, values)

    def sorted_sum(base, index, values):
        return base + segment_sum(index, values, base.shape[0])

    designs = {"index_add_rows": film_mod.index_add_rows,
               "index_add": plain, "segment_sum": sorted_sum}
    dp = make_problem(build_doublet(), spp=2048, resolution=24, lr=0.6,
                      iters=1, seed=0)
    fn = value_and_grad(dp.loss)

    def step():
        return fn(dp.params(), 0)[1]

    with record_calls(film_mod, "index_add_rows") as calls:
        step()
    ms = {d: [] for d in designs}
    call_ms = {d: 0.0 for d in designs}
    repeats = {}
    try:
        for name, impl in designs.items():
            film_mod.index_add_rows = impl
            a, b = step(), step()
            repeats[name] = all(same_bits(a[k], b[k]) for k in a)
            call_ms[name] = sum(events_ms(lambda: impl(*args, **kw), 5)
                                for args, kw in calls)
        for k in TURNS3:
            name = list(designs)[k]
            film_mod.index_add_rows = designs[name]
            ms[name].append(wall_ms(step, 3))
    finally:
        film_mod.index_add_rows = designs["index_add_rows"]
    return {"phase": "splat", "splat_calls": len(calls),
            "taps": [int(args[1].shape[0]) for args, _ in calls],
            "splat_ms": call_ms, "step_ms": ms,
            "median_step_ms": {d: statistics.median(v)
                               for d, v in ms.items()},
            "gradient_repeats": repeats}


def hit_calls(other, scene):
    """The wavefront PathIntegrator's BVH hit queries on the at-scale
    frame, made through the other checkout's kernels: {"closest": [...],
    "any": [...]} of (tables, o, d, maxt, active)."""
    calls = {"closest": [], "any": []}

    def recording(kind, fn):
        def call(*args):
            calls[kind].append(args)
            return fn(*args)
        return call

    ray, _, _, lane = sample_rays(scene, SEED, BVH_SPP)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    own = scene_mod.packet_closest_hit, scene_mod.packet_any_hit
    scene_mod.packet_closest_hit = recording("closest", other.closest_hit)
    scene_mod.packet_any_hit = recording("any", other.any_hit)
    try:
        PathIntegrator(MAX_DEPTH, RR_DEPTH).sample(scene, ray, lane, SEED,
                                                   active)
    finally:
        scene_mod.packet_closest_hit, scene_mod.packet_any_hit = own
    torch.cuda.synchronize()
    return calls


# the order of three designs' turns: a, b, c, c, b, a, twice over
TURNS3 = (0, 1, 2, 2, 1, 0, 0, 1, 2, 2, 1, 0)


def hits_phase(other, scene):
    calls = hit_calls(other, scene)
    tables = calls["closest"][0][0]
    n = int(calls["closest"][0][1].shape[0])
    deep = dataclasses.replace(tables, depth=tv.PAIR_STACK + 1)
    result = {"phase": "hits", "rays": n, "tree_depth": tables.depth}
    for kind, theirs, this in (
            ("closest", other.closest_hit, tv.packet_closest_hit),
            ("any", other.any_hit, tv.packet_any_hit)):
        designs = {"other": theirs, "this": this,
                   "this_miss_link": lambda tabs, *rays, fn=this: fn(deep,
                                                                     *rays)}
        differ = {"this": [], "this_miss_link": []}
        for i, c in enumerate(calls[kind]):
            ref = theirs(*c)
            for name, rays in differ.items():
                got = designs[name](*c)
                if kind == "any":
                    if not torch.equal(got, ref):
                        raise AssertionError(f"hits: {name} call {i}: "
                                             "occluded differs")
                else:
                    rays.append(int(((got[0].view(torch.int32)
                                      != ref[0].view(torch.int32))
                                     | (got[1] != ref[1])).sum()))
        names = list(designs)
        call_ms = {name: [] for name in names}
        for k in TURNS3:
            call_ms[names[k]].append(frame_ms(designs[names[k]],
                                              calls[kind])[1])
        result[kind] = {
            "active_rays": [int(c[4].sum()) for c in calls[kind]],
            "frame_ms": {k: [sum(t) for t in v] for k, v in call_ms.items()},
            "call_ms": {k: [statistics.median(t) for t in zip(*v)]
                        for k, v in call_ms.items()},
            "launch_config": tv.launch_config(n, tables.depth, kind),
            "miss_link_config": tv.launch_config(n, deep.depth, kind)}
        if kind == "any":
            result[kind]["occluded_equal"] = True
        else:
            result[kind]["rays_differ"] = differ
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path)
    parser.add_argument("--phases", default="idle,intersect,megakernel")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_designs: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    phases = opts.phases.split(",")
    alone = {"bvh_divergence", "laplacian", "gather", "splat"}
    if opts.other is None and set(phases) - alone:
        raise SystemExit("compare_designs: --other is needed for "
                         f"{sorted(set(phases) - alone)}")
    other = OtherKernels(opts.other.resolve()) if opts.other else None
    scene = cornell_box(SIZE, SIZE) if {"idle", "intersect", "megakernel"} \
        & set(phases) else None
    big = big_scene(SIZE, SIZE) if any(
        ph.startswith("bvh_") or ph in ("hits", "laplacian")
        for ph in phases) else None
    calls = frame_calls(other, scene) if {"idle", "intersect"} & set(
        phases) else None
    for phase in phases:
        if phase == "idle":
            out = idle_phase(other, calls)
        elif phase == "intersect":
            out = intersect_phase(other, calls)
        elif phase == "megakernel":
            out = megakernel_phase(other, scene)
        elif phase == "bvh_trace":
            out = bvh_trace_phase(other, big)
        elif phase == "bvh_bounce":
            out = bvh_bounce_phase(other, big)
        elif phase == "bvh_divergence":
            out = bvh_divergence_phase(big)
        elif phase == "hits":
            out = hits_phase(other, big)
        elif phase == "laplacian":
            out = laplacian_phase(big)
        elif phase == "gather":
            out = gather_phase()
        elif phase == "splat":
            out = splat_phase()
        else:
            raise SystemExit(f"compare_designs: unknown phase {phase}")
        print(json.dumps(out))


if __name__ == "__main__":
    main()
