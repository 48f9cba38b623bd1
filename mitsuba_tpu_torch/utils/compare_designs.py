"""Time this checkout's brute-force kernels against the one-thread-a-slot
designs they replaced, in one process on one GPU.

    python -m mitsuba_tpu_torch.utils.compare_designs --other DIR \
        [--phases idle,intersect,megakernel]

``DIR`` is the root of a checkout from before the persistent grids, for
example a ``git archive`` of that commit unpacked into the ignored
``_tree/``.  Its ``csrc/intersect_packed.cu`` and ``csrc/megakernel.cu``
are built with its own ``ops/_build.py`` into its own ``_build/`` and
called through their C interfaces

    intersect_packed(tris, n_faces, o, d, maxt, active, n,
                     t, prim, u, v, stream)
    megakernel_trace(tris, n_faces, light, n_lights, lanes, o, d, active,
                     seed, max_depth, rr_depth, smooth, n, out, stream)

The tool knows only those interfaces: it refuses a checkout whose
libraries export ``intersect_packed_config`` or
``megakernel_trace_config``, as the persistent-grid designs do.

All phases run BASELINE config 1: ``cornell_box(256, 256)``, 64 spp,
max_depth 6, rr_depth 5, seed 7.  Kernel times are
``profile_path.events_ms`` (CUDA-event medians of 5), each call timed
alone and summed over a frame's launches.

- ``idle``: the other checkout's ``intersect_packed`` on the 12 calls of
  the wavefront ``PathIntegrator`` (recorded through that kernel), as
  they are and with each call's active rays moved in front of the
  inactive ones (a stable sort by the mask).  Same tests, fewer thread
  slots: the gap between the two sums is the time that threads holding
  inactive slots cost.  The packed outputs must equal the unpacked ones
  bit for bit.
- ``intersect``: both ``intersect_packed`` on the same calls, in turns
  (other, this, this, other); every output of every call must be equal
  bit for bit.
- ``megakernel``: both ``megakernel_trace`` on the frame's primary rays,
  in turns (other, this, this, other); the radiance of every lane must be
  equal bit for bit.

Prints the card's name and power limit, then one JSON line a phase.
Fails without a GPU and on any disagreement.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

from .. import PathIntegrator, cornell_box
from ..core import rng
from ..models import scene as scene_mod
from ..models.integrators import sample_rays
from ..ops import intersect_packed as ip
from ..ops import megakernel as mk
from .profile_path import events_ms

SIZE = 256
SPP = 64
SEED = 7
MAX_DEPTH = 6
RR_DEPTH = 5


class OtherKernels:
    """The other checkout's two brute-force kernels, through ctypes."""

    def __init__(self, root: Path):
        path = root / "mitsuba_tpu_torch" / "ops" / "_build.py"
        spec = importlib.util.spec_from_file_location("other_build", path)
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        p, i = ctypes.c_void_p, ctypes.c_int
        self._ip = self._entry(build, "intersect_packed", root)
        self._ip.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p]
        self._ip.restype = i
        self._mk = self._entry(build, "megakernel", root, "megakernel_trace")
        self._mk.argtypes = [p, i, p, i, p, p, p, p, ctypes.c_uint32, i, i,
                             i, i, p, p]
        self._mk.restype = i

    @staticmethod
    def _entry(build, source, root, name=None):
        """``name`` (default ``source``) of the other checkout's library,
        which must be a one-thread-a-slot design."""
        name = name or source
        lib = build.load(source)
        if hasattr(lib, f"{name}_config"):
            raise SystemExit(f"compare_designs: {root}'s {name} exports "
                             f"{name}_config, a persistent-grid interface "
                             "this tool does not know")
        return getattr(lib, name)

    def intersect(self, tris, o, d, maxt, active):
        n = int(o.shape[0])
        dev = o.device
        t = torch.empty(n, dtype=torch.float32, device=dev)
        prim = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        rc = self._ip(tris.data_ptr(), int(tris.shape[1]), o.data_ptr(),
                      d.data_ptr(), maxt.data_ptr(), active.data_ptr(), n,
                      t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                      v.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other intersect_packed: CUDA error {rc}")
        return t, prim, u, v

    def trace(self, tris, light, lane, o, d, active, seed, n_faces,
              n_lights):
        n = int(o.shape[0])
        out = torch.empty((n, 3), dtype=torch.float32, device=o.device)
        rc = self._mk(tris.data_ptr(), n_faces, light.data_ptr(), n_lights,
                      lane.data_ptr(), o.data_ptr(), d.data_ptr(),
                      active.data_ptr(), int(seed) & rng.MASK32, MAX_DEPTH,
                      RR_DEPTH, 0, n, out.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other megakernel_trace: CUDA error {rc}")
        return out


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


def in_turns(designs, calls):
    """Each design's frame ms, timed in turns (a, b, b, a)."""
    (a, fa), (b, fb) = designs.items()
    times = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        times[name].append(frame_ms(fn, calls)[0])
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
    tris, light, n_faces, n_lights = mk.pack_scene(scene)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True)
    parser.add_argument("--phases", default="idle,intersect,megakernel")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_designs: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    other = OtherKernels(opts.other.resolve())
    scene = cornell_box(SIZE, SIZE)
    phases = opts.phases.split(",")
    calls = frame_calls(other, scene) if {"idle", "intersect"} & set(
        phases) else None
    for phase in phases:
        if phase == "idle":
            out = idle_phase(other, calls)
        elif phase == "intersect":
            out = intersect_phase(other, calls)
        elif phase == "megakernel":
            out = megakernel_phase(other, scene)
        else:
            raise SystemExit(f"compare_designs: unknown phase {phase}")
        print(json.dumps(out))


if __name__ == "__main__":
    main()
