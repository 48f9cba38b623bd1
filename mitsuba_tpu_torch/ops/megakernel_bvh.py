"""BVH path-tracing megakernels (mitsuba_tpu/ops/pallas/megakernel.py,
``megakernel_bounce_bvh`` and ``megakernel_trace_bvh``).

The brute kernel (ops/megakernel.py) tests every face and stops at
``MAX_FACES``; these walk the scene's host-built BVH (ops/bvh.py)
instead, so any face count renders.  Both run the same bounce body as the
brute kernel (csrc/path_common.cuh; ``megakernel.bounce_step`` in the
plain versions), so the per-lane radiance of a lane does not depend on
which of the three computed it beyond float rounding.

- ``pack_scene_bvh``: ``pack_scene``'s 39-column face table (face order)
  and light table, the node arrays and the leaf triangles in leaf-slot
  order (ops/traverse.py ``pack_bvh_geometry``, which the wavefront's BVH
  queries and the plain walk read), and the tree's records of both
  children's boxes (ops/bvh.py ``pack_node_pairs``, once a tree at its
  build), which the kernels' walk reads;
- ``megakernel_bounce_bvh``: one bounce over the (16, N) per-lane state
  at one depth, updating it in place; ``megapath._sorted_bvh`` launches
  it once per depth with the lanes re-sorted in between;
- ``megakernel_trace_bvh``: every bounce in one launch, per-lane L;
- ``launch_config``: the persistent grid either kernel launches;
- ``*_plain``: the plain PyTorch versions, over the same tables.

On a CUDA tensor a wrapper launches its kernel of
``csrc/megakernel_bvh.cu`` (built with nvcc at first use) or raises; on
a CPU tensor it runs the plain version.  Both kernels run persistent
threads that take lanes from a counter the wrapper allocates, and walk
the tree with a stack of at most ``launch_config(...)["stack_cap"]``
entries (``STACK_CAP``): a wrapper raises for a deeper tree, and
``megakernel_bvh_applicable`` turns such a scene away, so that
``MegakernelPathIntegrator`` takes the wavefront path, whose miss-link
walk needs no stack.  The ported BSDF codes are those of
``megakernel_trace`` (0-7 and 16-23, flat or smooth normals, an area
light, an environment map or both), in the same builds, with one
exception, as in the JAX package: ``megakernel_trace_bvh`` takes no
texture arena and no environment map, so it raises for a textured code
(5 or 21) or tables that carry an environment map, and ``megapath``
sends such a scene through the per-depth pipeline of
``megakernel_bounce_bvh``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..core import rng
from . import _build
from .megakernel import (LIGHT_COLS, MAX_LIGHT_FACES, TRI_COLS, bounce_step,
                         check_tensor, check_variant, env_args, env_ptrs,
                         env_view, initial_state, lobes_flag, pack_scene,
                         plugin_subset_ok, tex_args, textured)
from .traverse import (PAIR_STACK, BvhGeometry, check_geometry,
                       pack_bvh_geometry, packet_any_hit_plain,
                       packet_closest_hit_plain)

STATE_COLS = 16    # o(3) d(3) L(3) throughput(3) eta_acc prev_pdf prev_delta act
# the deepest tree the kernels' walk takes: the entries of its stack
# (csrc/bvh_pair_walk.cuh PAIR_STACK, which launch_config reports)
STACK_CAP = PAIR_STACK


def megakernel_bvh_applicable(scene) -> bool:
    """True iff the BVH kernels take the scene: it carries a BVH (built
    at ``make_scene`` above MAX_FACES faces) no deeper than the walk's
    ``STACK_CAP``, and its plugins are inside the ported subset."""
    return (scene.accel is not None and scene.accel.depth <= STACK_CAP
            and plugin_subset_ok(scene))


@dataclass
class BvhTables(BvhGeometry):
    """What the BVH kernels and their plain versions read: the walk's
    tables, plus the face table in face order, whose winner's row is read
    once after the walk, the light table, the texture arena and the
    environment map's arena, meta and position (``pack_env``).  The
    kernels walk ``node_pair`` in place of the node arrays."""

    tris: torch.Tensor = None   # (F, TRI_COLS) pack_scene's face table
    light: torch.Tensor = None  # (max(L, 1), LIGHT_COLS)
    tex: torch.Tensor | None = None   # pack_scene's texture arena
    env_data: torch.Tensor | None = None   # the environment map's arena
    env_meta: torch.Tensor | None = None   # (ENV_COLS,)
    env_pos: int = -1
    n_faces: int = 0
    n_lights: int = 0

    @property
    def nbytes(self) -> int:
        return super().nbytes + sum(t.numel() * t.element_size()
                                    for t in (self.tris, self.light, self.tex,
                                              self.env_data)
                                    if t is not None)

    @property
    def env(self) -> dict:
        """The environment map's keyword arguments, {} without one."""
        return env_args(self.env_data, self.env_meta, self.env_pos)


def pack_scene_bvh(scene) -> BvhTables:
    """Tables of the BVH kernels for a scene with ``scene.accel``
    (megakernel.py:1896 of the JAX package, without its TPU leaf-row,
    MXU and resolve layouts)."""
    tris, light, n_faces, n_lights, tex, env = pack_scene(scene)
    geo = pack_bvh_geometry(scene.accel, tris[:, 0:9])
    return BvhTables(**vars(geo), tris=tris, light=light, tex=tex, **env,
                     n_faces=n_faces, n_lights=n_lights)


# ------------------------------------------------------------ the wrappers

def megakernel_bounce_bvh(tables: BvhTables, lane, seed, state, depth: int,
                          max_depth: int, rr_depth: int,
                          smooth: bool = False, btypes: tuple = (0,)):
    """One bounce at ``depth`` over the (16, N) float32 state (rows as
    ``STATE_COLS`` says; prev_delta and act as 0/1).  Updates ``state``
    IN PLACE and returns it.  Lanes whose act is 0 are left as they are;
    for a lane that ends in this bounce only L and act are meaningful.
    A textured face reads the tables' texture arena, an escaped ray and
    the NEE the tables' environment map.

    On a CUDA tensor this launches the kernel (counted in
    ``megakernel_bounce_bvh.launches``) or raises; on a CPU tensor it
    runs ``megakernel_bounce_bvh_plain``."""
    btypes = check_variant(btypes, tables.tex, tables.env_data,
                           tables.env_meta, tables.env_pos)
    if state.device.type == "cpu":
        state.copy_(megakernel_bounce_bvh_plain(
            tables, lane, seed, state, depth, max_depth, rr_depth, smooth,
            btypes=btypes))
        return state
    dev = state.device
    n = int(state.shape[1])
    _check_tables(tables, dev)
    check_tensor("lane", lane, torch.int32, (n,), dev)
    check_tensor("state", state, torch.float32, (STATE_COLS, n), dev)
    tex_ptr, n_tex = tex_args(tables.tex, dev)
    env_ptr, n_env, meta, env_pos = env_ptrs(tables.env, dev)
    fn = _library().megakernel_bounce_bvh
    next_slot = torch.zeros(1, dtype=torch.int32, device=dev)  # the schedule
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*_table_ptrs(tables), tex_ptr, n_tex, env_ptr, n_env,
                ctypes.addressof(meta), env_pos, lane.data_ptr(),
                state.data_ptr(), n,
                int(seed) & rng.MASK32, depth, max_depth, rr_depth,
                int(smooth), lobes_flag(btypes, env_pos >= 0),
                next_slot.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel_bounce_bvh launch failed: CUDA error {rc}")
    megakernel_bounce_bvh.launches += 1
    return state


megakernel_bounce_bvh.launches = 0


def megakernel_trace_bvh(tables: BvhTables, lane, o, d, active, seed,
                         max_depth: int, rr_depth: int,
                         smooth: bool = False, btypes: tuple = (0,)):
    """Per-lane path radiance L (N, 3) for rays (o, d), every bounce in
    one launch.  On a CUDA tensor this launches the kernel (counted in
    ``megakernel_trace_bvh.launches``) or raises; on a CPU tensor it runs
    ``megakernel_trace_bvh_plain``.  Raises ``ValueError`` for a textured
    code (5 or 21) and for tables with an environment map: the single
    launch takes no texture arena and no environment map, as the JAX
    package's."""
    btypes = check_variant(btypes)
    if textured(btypes):
        raise ValueError(f"BSDF types {btypes} hold a textured diffuse, "
                         "which megakernel_trace_bvh does not take; "
                         "megakernel_bounce_bvh does")
    if tables.env:
        raise ValueError("megakernel_trace_bvh takes no environment map; "
                         "megakernel_bounce_bvh does")
    if o.device.type == "cpu":
        return megakernel_trace_bvh_plain(tables, lane, o, d, active, seed,
                                          max_depth, rr_depth, smooth,
                                          btypes=btypes)
    dev = o.device
    n = int(o.shape[0])
    _check_tables(tables, dev)
    check_tensor("lane", lane, torch.int32, (n,), dev)
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    fn = _library().megakernel_trace_bvh
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    next_slot = torch.zeros(1, dtype=torch.int32, device=dev)  # the schedule
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*_table_ptrs(tables), lane.data_ptr(), o.data_ptr(),
                d.data_ptr(), active.data_ptr(), int(seed) & rng.MASK32,
                max_depth, rr_depth, int(smooth), lobes_flag(btypes), n,
                out.data_ptr(), next_slot.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel_trace_bvh launch failed: CUDA error {rc}")
    megakernel_trace_bvh.launches += 1
    return out


megakernel_trace_bvh.launches = 0


def _check_tables(t: BvhTables, dev):
    check_geometry(t, dev)
    check_tensor("tris", t.tris, torch.float32, (None, TRI_COLS), dev)
    check_tensor("light", t.light, torch.float32, (None, LIGHT_COLS), dev)
    if t.tris.shape[0] < t.n_faces or t.light.shape[0] < t.n_lights \
            or not 0 <= t.n_lights <= MAX_LIGHT_FACES:
        raise ValueError("tables are shorter than n_faces / n_lights, or "
                         f"more than {MAX_LIGHT_FACES} light faces")
    if t.depth > STACK_CAP:
        raise ValueError(f"the BVH is {t.depth} inner nodes deep; the "
                         f"kernels' walk takes at most {STACK_CAP}")


def _table_ptrs(t: BvhTables):
    return (t.node_pair.data_ptr(), t.leaf_geo.data_ptr(),
            t.leaf_face.data_ptr(), t.tris.data_ptr(), t.light.data_ptr(),
            t.n_lights)


def _library():
    lib = _build.load("megakernel_bvh")
    if lib.megakernel_bounce_bvh.argtypes is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.megakernel_bounce_bvh.argtypes = [p, p, p, p, p, i, p, i, p, i,
                                              p, i, p, p, i, u, i, i, i, i,
                                              i, p, p]
        lib.megakernel_bounce_bvh.restype = i
        lib.megakernel_trace_bvh.argtypes = [p, p, p, p, p, i, p, p, p, p,
                                             u, i, i, i, i, i, p, p, p]
        lib.megakernel_trace_bvh.restype = i
        for kernel in ("bounce", "trace"):
            entry = getattr(lib, f"megakernel_{kernel}_bvh_config")
            entry.argtypes = [i, i, i, p]
            entry.restype = i
    return lib


def launch_config(kernel: str, n: int, btypes: tuple = (0,),
                  env: bool = False) -> dict:
    """The persistent grid of ``megakernel_{kernel}_bvh`` ("bounce" or
    "trace"; only the bounce kernel has builds with an environment map,
    ``env``) over ``n`` lanes on the current CUDA device: blocks, resident
    blocks per SM (the occupancy calculator's), threads a block, SMs, and
    the deepest tree (``BvhTables.depth``) its walk takes."""
    cfg = (ctypes.c_int * 5)()
    rc = getattr(_library(), f"megakernel_{kernel}_bvh_config")(
        n, lobes_flag(btypes, env), int(env), cfg)
    if rc != 0:
        raise RuntimeError(f"megakernel_{kernel}_bvh_config: CUDA error {rc}")
    return {"blocks": cfg[0], "resident_per_sm": cfg[1], "threads": cfg[2],
            "sms": cfg[3], "stack_cap": cfg[4]}


# --------------------------------------------------------- the plain versions

def _bvh_queries(tables: BvhTables, counts):
    """(closest, anyhit) of ``bounce_step``: the wavefront's plain BVH
    queries (ops/traverse.py) over the lanes in ``act``, as in the
    kernels."""

    def closest(ox, oy, oz, dx, dy, dz, act):
        t, face = packet_closest_hit_plain(
            tables, torch.stack([ox, oy, oz], -1),
            torch.stack([dx, dy, dz], -1), torch.full_like(ox, float("inf")),
            act, counts=counts, key="closest_tests")
        return t, face.long()

    def anyhit(ox, oy, oz, dx, dy, dz, maxt, act):
        return packet_any_hit_plain(
            tables, torch.stack([ox, oy, oz], -1),
            torch.stack([dx, dy, dz], -1), maxt, act, counts=counts,
            key="shadow_tests")

    return closest, anyhit


def _unpack(state):
    rows = state.unbind(0)
    return rows[:14] + (rows[14] > 0.5, rows[15] > 0.5)


def _pack(st):
    return torch.stack([*st[:14], st[14].to(torch.float32),
                        st[15].to(torch.float32)])


def primary_state(o, d, active):
    """The (16, N) state of ``megakernel_bounce_bvh`` for primary rays
    (N, 3) and a bool mask: L = 0, throughput, eta_acc, prev_pdf and
    prev_delta = 1, act = active."""
    return _pack(initial_state(o, d, active))


def megakernel_bounce_bvh_plain(tables: BvhTables, lane, seed, state,
                                depth: int, max_depth: int, rr_depth: int,
                                smooth: bool = False,
                                counts: dict | None = None,
                                btypes: tuple = (0,)):
    """Plain PyTorch version of one bounce, on any device; returns the new
    (16, N) state and leaves ``state`` as it is.  When ``counts`` is a
    dict it receives ``node_visits``, ``closest_tests`` and
    ``shadow_tests``: the boxes and triangles the kernel tests on these
    inputs (an any-hit walk stops at its first occluder)."""
    closest, anyhit = _bvh_queries(tables, counts)
    return _pack(bounce_step(tables.tris, closest, anyhit, tables.light,
                             tables.n_lights, depth, max_depth, rr_depth,
                             rng.as_u32(lane), seed, _unpack(state), smooth,
                             btypes, tables.tex, counts,
                             env_view(**tables.env)))


def megakernel_trace_bvh_plain(tables: BvhTables, lane, o, d, active, seed,
                               max_depth: int, rr_depth: int,
                               smooth: bool = False,
                               counts: dict | None = None,
                               btypes: tuple = (0,)):
    """Plain PyTorch version of ``megakernel_trace_bvh``: the plain bounce
    looped over every depth.  ``counts`` as in the bounce.  It also takes
    a textured scene and an environment map, and so is the plain version
    of the per-depth pipeline's whole path too."""
    closest, anyhit = _bvh_queries(tables, counts)
    lane = rng.as_u32(lane)
    state = initial_state(o, d, active)
    env = env_view(**tables.env)
    for depth in range(max_depth):
        state = bounce_step(tables.tris, closest, anyhit, tables.light,
                            tables.n_lights, depth, max_depth, rr_depth, lane,
                            seed, state, smooth, btypes, tables.tex, counts,
                            env)
    return torch.stack(state[6:9], dim=-1)
