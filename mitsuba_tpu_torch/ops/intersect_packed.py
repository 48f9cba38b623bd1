"""Brute-force closest hit over a packed face table
(mitsuba_tpu/ops/pallas/intersect_pallas.py, ``intersect_packed``).

The wavefront ``PathIntegrator`` queries it twice a depth on scenes
without a BVH (at most ``MAX_FACES`` faces): closest hit, then the
shadow rays through ``isfinite(t)``.

- ``pack_triangles``: the (9, F) table [p0 | e1 | e2], one face a
  column (the JAX package's table without its padding to a multiple of
  128 columns, which only the TPU's lanes need);
- ``intersect_packed``: the wrapper.  On a CUDA tensor it launches the
  hand-written kernel in ``csrc/intersect_packed.cu`` (built with nvcc at
  first use) or raises; on a CPU tensor it runs the plain version.  The
  kernel compacts the active rays of each chunk of slots into a queue in
  shared memory and gives every thread one of them at a time, so warps
  sweep the faces on live rays only; ``launch_config`` reports the
  persistent grid it uses;
- ``intersect_packed_plain``: the plain PyTorch version, a sweep over the
  faces with the kernel's tie rule.

**Tie rule**, the TPU kernel's: faces are swept upward in 128-face
blocks; among equal t within a block the LARGEST index wins, while a
later block replaces an earlier block's hit only with a strictly
smaller t.  So face ``j`` replaces the best ``bj`` if ``t < bt``, or if
``t == bt`` and ``j >> 7 == bj >> 7``.  (``megakernel_trace``'s sweep
keeps the lowest index instead, as its TPU kernel does.)
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .intersect import tri_test_uv
from .megakernel import MAX_FACES, check_tensor

T_BLOCK = 128   # faces per block of the tie rule (the TPU kernel's lane width)


def pack_triangles(vertices, faces):
    """(V, 3), (F, 3) -> (9, F) float32 rows [p0 | e1 | e2]."""
    p0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - p0
    e2 = vertices[faces[:, 2]] - p0
    return torch.cat([p0, e1, e2], dim=1).T.contiguous()


def intersect_packed(tris, o, d, maxt, active):
    """Closest hit of rays (o, d) (N, 3) within ``maxt`` (N,) over the
    faces of ``tris`` (9, F), for the lanes of ``active`` (N,) bool.

    Returns (t, prim, u, v): t = inf, prim = -1 and u = v = 0 on a miss
    and on an inactive lane.  On a CUDA tensor this launches the kernel
    (counted in ``intersect_packed.launches``) or raises; on a CPU tensor
    it runs ``intersect_packed_plain``.
    """
    if int(tris.shape[1]) > MAX_FACES:
        raise ValueError(f"{tris.shape[1]} faces: the kernel stages at most "
                         f"{MAX_FACES}")
    if o.device.type == "cpu":
        return intersect_packed_plain(tris, o, d, maxt, active)
    dev = o.device
    n = int(o.shape[0])
    check_tensor("tris", tris, torch.float32, (9, None), dev)
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("maxt", maxt, torch.float32, (n,), dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _library().intersect_packed
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(tris.data_ptr(), int(tris.shape[1]), o.data_ptr(),
                d.data_ptr(), maxt.data_ptr(), active.data_ptr(), n,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"intersect_packed launch failed: CUDA error {rc}")
    intersect_packed.launches += 1
    return t, prim, u, v


intersect_packed.launches = 0


def launch_config(n_faces: int, n: int) -> dict:
    """The persistent grid of a launch over ``n`` rays and ``n_faces``
    faces on the current CUDA device: blocks, resident blocks per SM (the
    occupancy calculator's), threads a block (a batch of queued rays, one
    a thread), SMs, and the ray slots a block compacts at a time."""
    cfg = (ctypes.c_int * 5)()
    rc = _library().intersect_packed_config(n_faces, n, cfg)
    if rc != 0:
        raise RuntimeError(f"intersect_packed_config: CUDA error {rc}")
    return {"blocks": cfg[0], "resident_per_sm": cfg[1], "threads": cfg[2],
            "sms": cfg[3], "chunk": cfg[4]}


def _library():
    lib = _build.load("intersect_packed")
    if lib.intersect_packed.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.intersect_packed.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p]
        lib.intersect_packed.restype = i
        lib.intersect_packed_config.argtypes = [i, i, p]
        lib.intersect_packed_config.restype = i
    return lib


def intersect_packed_plain(tris, o, d, maxt, active,
                           counts: dict | None = None):
    """Plain PyTorch version of the kernel, on any device: the sweep over
    the faces with the tie rule of the module docstring, one 128-face
    block at a time.  Each face's test is the kernel's arithmetic on
    (rays, faces) tensors; within a block the smallest t wins and, among
    equal t, the largest index, which is what the sequential sweep keeps;
    a block replaces the earlier blocks' hit only with a strictly smaller
    t.  Rays go in chunks of at most ``PLAIN_ELEMENTS`` (ray, face)
    pairs.  When ``counts`` is a dict, ``counts["tests"]`` grows by the
    ray-triangle tests the kernel does: every face for each lane it
    takes."""
    n, n_faces = int(o.shape[0]), int(tris.shape[1])
    chunk = max(1, PLAIN_ELEMENTS // min(max(n_faces, 1), T_BLOCK))
    outs = [_plain_chunk(tris, o[i:i + chunk], d[i:i + chunk],
                         maxt[i:i + chunk]) for i in range(0, max(n, 1), chunk)]
    bt, bj, bu, bv = (torch.cat(x) for x in zip(*outs))
    bt = torch.where(active, bt, float("inf"))
    bj = torch.where(active, bj, -1)
    bu = torch.where(active, bu, 0.0)
    bv = torch.where(active, bv, 0.0)
    if counts is not None:
        counts["tests"] = (counts.get("tests", 0)
                           + int(active.sum()) * n_faces)
    return bt, bj.to(torch.int32), bu, bv


PLAIN_ELEMENTS = 1 << 24   # (ray, face) pairs of one step of the plain sweep


def _plain_chunk(tris, o, d, maxt):
    """The sweep of ``intersect_packed_plain`` over every face for the
    rays (o, d, maxt), before the active mask: (t, face, u, v)."""
    ox, oy, oz = (x[:, None] for x in o.unbind(-1))
    dx, dy, dz = (x[:, None] for x in d.unbind(-1))
    bt = torch.full(ox.shape[:1], float("inf"), device=o.device)
    bj = torch.full(bt.shape, -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    for b0 in range(0, int(tris.shape[1]), T_BLOCK):
        c = tris[:, b0:b0 + T_BLOCK]
        hit, t, u, v = tri_test_uv(*(row[None, :] for row in c), ox, oy, oz,
                                   dx, dy, dz, maxt[:, None])
        t = torch.where(hit, t, float("inf"))
        tmin = t.amin(dim=1)
        # the largest index of the block's smallest t
        j = torch.arange(c.shape[1], device=o.device)
        last = torch.where(hit & (t == tmin[:, None]), j, -1).amax(dim=1)
        win = tmin < bt
        pick = last.clamp(min=0)[:, None]
        bt = torch.where(win, tmin, bt)
        bj = torch.where(win, b0 + last, bj)
        bu = torch.where(win, u.gather(1, pick)[:, 0], bu)
        bv = torch.where(win, v.gather(1, pick)[:, 0], bv)
    return bt, bj, bu, bv
