"""BVH closest-hit and any-hit ray queries
(mitsuba_tpu/ops/pallas/traverse.py, ``packet_closest_hit`` and
``packet_any_hit``).

The wavefront ``PathIntegrator`` queries them once a depth each on scenes
that carry a BVH (above ``MAX_FACES`` faces): closest hit, then shadow
rays.  The names are the TPU kernels'.  Their function is too (t and face
id, or occluded, for (N, 3) rays with per-ray maxt and an active mask),
but not their tree: the packet BVH, MXU leaf stage and SMEM queues are a
TPU layout.  The port walks its own SAH tree (ops/bvh.py), ONE RAY PER
THREAD, with the miss-link walk of csrc/bvh_walk.cuh, so ties follow
``ops/bvh.py::walk`` (the first face in DFS order among equal t).

- ``BvhGeometry``/``pack_bvh_geometry``: the node arrays and leaf
  triangles the walks read (``megakernel_bvh.BvhTables`` extends them
  with the megakernels' shading tables);
- ``packet_closest_hit``/``packet_any_hit``: the wrappers.  On a CUDA
  tensor each launches its kernel of ``csrc/traverse.cu`` (built with
  nvcc at first use) or raises; on a CPU tensor it runs the plain version;
- ``*_plain``: the plain versions, ``ops/bvh.py::walk``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .bvh import BVH, walk
from .megakernel import check_tensor

NODE_BOX_COLS = 8  # lo xyz, 0, hi xyz, 0: two float4 per node
NODE_META_COLS = 4  # first, count, miss, 0: one int4 per node
LEAF_GEO_COLS = 12  # p0 | e1 | e2 | 0 0 0: three float4 per leaf slot


@dataclass
class BvhGeometry:
    """What a walk reads: the tree's node arrays and the leaf triangles,
    copied into leaf-slot order so that a leaf's tests read consecutive
    memory."""

    node_box: torch.Tensor    # (M, NODE_BOX_COLS) float32
    node_meta: torch.Tensor   # (M, NODE_META_COLS) int32
    leaf_geo: torch.Tensor    # (P, LEAF_GEO_COLS) float32
    leaf_face: torch.Tensor   # (P,) int32 face of each slot, -1 padding

    def bvh(self) -> BVH:
        """The tree as ops/bvh.py's record, as views of the node arrays."""
        return BVH(bbox_lo=self.node_box[:, 0:3], bbox_hi=self.node_box[:, 4:7],
                   first=self.node_meta[:, 0], count=self.node_meta[:, 1],
                   miss=self.node_meta[:, 2], prims=self.leaf_face)

    def tensors(self):
        return (self.node_box, self.node_meta, self.leaf_geo, self.leaf_face)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


def pack_bvh_geometry(accel: BVH, geo) -> BvhGeometry:
    """The tables of the tree ``accel`` over faces whose (F, 9) rows
    ``geo`` are [p0 | e1 | e2] in face order."""
    dev = geo.device
    m = accel.n_nodes
    zero = torch.zeros((m, 1), device=dev)
    node_box = torch.cat([accel.bbox_lo, zero, accel.bbox_hi, zero], 1)
    node_meta = torch.stack([accel.first, accel.count, accel.miss,
                             torch.zeros_like(accel.miss)], 1).to(torch.int32)
    face = accel.prims.to(torch.int32)
    rows = torch.where((face >= 0)[:, None],
                       geo[face.clamp(min=0).long()], 0.0)
    leaf_geo = torch.cat([rows, torch.zeros((rows.shape[0], 3), device=dev)],
                         1)
    return BvhGeometry(node_box=node_box.contiguous(),
                       node_meta=node_meta.contiguous(),
                       leaf_geo=leaf_geo.contiguous(),
                       leaf_face=face.contiguous())


def check_geometry(g: BvhGeometry, dev):
    """Raise ValueError unless the tables are what the kernels take."""
    check_tensor("node_box", g.node_box, torch.float32, (None, NODE_BOX_COLS),
                 dev)
    check_tensor("node_meta", g.node_meta, torch.int32,
                 (g.node_box.shape[0], NODE_META_COLS), dev)
    check_tensor("leaf_geo", g.leaf_geo, torch.float32, (None, LEAF_GEO_COLS),
                 dev)
    check_tensor("leaf_face", g.leaf_face, torch.int32,
                 (g.leaf_geo.shape[0],), dev)
    for name in ("node_box", "node_meta", "leaf_geo"):
        if getattr(g, name).data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# ------------------------------------------------------------ the wrappers

def _check_rays(o, d, maxt, active):
    dev = o.device
    n = int(o.shape[0])
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    check_tensor("maxt", maxt, torch.float32, (n,), dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    return dev, n


def _ray_ptrs(o, d, maxt, active):
    return (o.data_ptr(), d.data_ptr(), maxt.data_ptr(), active.data_ptr(),
            int(o.shape[0]))


def packet_closest_hit(tables: BvhGeometry, o, d, maxt, active):
    """Closest hit of rays (o, d) (N, 3) within ``maxt`` (N,) for the
    lanes of ``active`` (N,) bool: (t, face) with t = inf and face = -1
    on a miss or an inactive lane.  On a CUDA tensor this launches the
    kernel (counted in ``packet_closest_hit.launches``) or raises; on a
    CPU tensor it runs ``packet_closest_hit_plain``."""
    if o.device.type == "cpu":
        return packet_closest_hit_plain(tables, o, d, maxt, active)
    dev, n = _check_rays(o, d, maxt, active)
    check_geometry(tables, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    fn = _library().packet_closest_hit
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in tables.tensors()),
                *_ray_ptrs(o, d, maxt, active), t.data_ptr(), face.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"packet_closest_hit launch failed: CUDA error {rc}")
    packet_closest_hit.launches += 1
    return t, face


packet_closest_hit.launches = 0


def packet_any_hit(tables: BvhGeometry, o, d, maxt, active):
    """Whether any face lies within ``maxt`` of rays (o, d), (N,) bool,
    false on an inactive lane.  On a CUDA tensor this launches the kernel
    (counted in ``packet_any_hit.launches``) or raises; on a CPU tensor
    it runs ``packet_any_hit_plain``."""
    if o.device.type == "cpu":
        return packet_any_hit_plain(tables, o, d, maxt, active)
    dev, n = _check_rays(o, d, maxt, active)
    check_geometry(tables, dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    fn = _library().packet_any_hit
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in tables.tensors()),
                *_ray_ptrs(o, d, maxt, active), occ.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"packet_any_hit launch failed: CUDA error {rc}")
    packet_any_hit.launches += 1
    return occ


packet_any_hit.launches = 0


def _library():
    lib = _build.load("traverse")
    if lib.packet_closest_hit.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.packet_closest_hit.argtypes = [p, p, p, p, p, p, p, p, i, p, p, p]
        lib.packet_closest_hit.restype = i
        lib.packet_any_hit.argtypes = [p, p, p, p, p, p, p, p, i, p, p]
        lib.packet_any_hit.restype = i
    return lib


# --------------------------------------------------------- the plain versions

def packet_closest_hit_plain(tables: BvhGeometry, o, d, maxt, active,
                             counts: dict | None = None, key: str = "tests"):
    """Plain version of ``packet_closest_hit``: ops/bvh.py's walk.  When
    ``counts`` is a dict it receives ``node_visits`` and ``key``
    (triangle tests) of the walk on these inputs."""
    t, slot = walk(tables.bvh(), tables.leaf_geo, o, d, maxt, active,
                   counts=counts, key=key)
    face = torch.where(slot >= 0, tables.leaf_face.long()[slot.clamp(min=0)],
                       -1)
    return t, face.to(torch.int32)


def packet_any_hit_plain(tables: BvhGeometry, o, d, maxt, active,
                         counts: dict | None = None, key: str = "tests"):
    """Plain version of ``packet_any_hit``: ops/bvh.py's any-hit walk,
    which stops at a lane's first occluder.  ``counts`` as in
    ``packet_closest_hit_plain``."""
    t, _ = walk(tables.bvh(), tables.leaf_geo, o, d, maxt, active,
                any_hit=True, counts=counts, key=key)
    return torch.isfinite(t)
