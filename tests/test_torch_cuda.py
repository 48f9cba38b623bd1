"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one.  They
import only the port, so they run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Per-lane bar of tests/test_megakernel.py: rounding may flip a rare
russian-roulette or visibility decision, nothing more.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                               big_scene, cornell_box, render)
from mitsuba_tpu_torch.models.bsdfs import (CONDUCTOR_IOR, RoughConductor,
                                            RoughDielectric, SmoothConductor,
                                            SmoothDielectric)
from mitsuba_tpu_torch.models.integrators import sample_rays
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.shapes import Mesh
from mitsuba_tpu_torch.ops import bvh
from mitsuba_tpu_torch.ops import intersect_packed as ip
from mitsuba_tpu_torch.ops import megakernel as mk
from mitsuba_tpu_torch.ops import megakernel_bvh as mkb
from mitsuba_tpu_torch.ops.intersect_packed import (intersect_packed,
                                                    intersect_packed_plain,
                                                    pack_triangles)
from mitsuba_tpu_torch.ops.megakernel import (megakernel_trace,
                                              megakernel_trace_plain,
                                              pack_scene, scene_btypes)
from mitsuba_tpu_torch.ops.megakernel_bvh import (
    megakernel_bounce_bvh, megakernel_bounce_bvh_plain, megakernel_trace_bvh,
    megakernel_trace_bvh_plain, pack_scene_bvh, primary_state)
from mitsuba_tpu_torch.ops import traverse as tv
from mitsuba_tpu_torch.ops.traverse import (packet_any_hit,
                                            packet_any_hit_plain,
                                            packet_closest_hit,
                                            packet_closest_hit_plain)
from mitsuba_tpu_torch.utils.scenes import (envmap_big_scene, envmap_scene,
                                            plastic_cornell,
                                            surfaces_big_scene,
                                            textured_cornell, twosided_cornell)

from torch_parity import nested_clusters, rounding_tree

pytestmark = pytest.mark.cuda


def assert_lanes_close(got, ref):
    assert torch.isfinite(got).all()
    close = torch.isclose(got, ref, rtol=2e-3, atol=2e-3).all(dim=-1)
    assert close.float().mean() >= 0.995
    assert abs(got.mean() - ref.mean()) / ref.mean() < 2e-3


def assert_hits_agree(t, prim, t_ref, prim_ref):
    """chip_smoke.py's bar: hit and prim agree on 99.99 % of rays, t
    within 1e-5 relative."""
    hit, hit_ref = torch.isfinite(t), torch.isfinite(t_ref)
    same = (hit == hit_ref) & (prim.long() == prim_ref.long())
    both = hit & hit_ref
    same[both] &= (t[both] - t_ref[both]).abs() <= 1e-5 * t_ref[both].abs()
    assert same.float().mean() >= 0.9999


def random_maxt(o):
    """A finite maxt for each ray of origins ``o``: uniform in (0, 3)."""
    g = torch.Generator(device=o.device).manual_seed(0)
    return 3.0 * torch.rand(o.shape[0], generator=g, device=o.device)


@pytest.fixture
def cuda_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = cornell_box(32, 32, device="cuda")
    ray, _, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    return ((tris, light, lane, ray.o, ray.d, active, 5),
            dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights))


@pytest.fixture(scope="module")
def bvh_inputs():
    """Cornell box + a 5,120-face smooth icosphere at 32x32 x 2 spp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = big_scene(32, 32, subdiv=4, device="cuda")
    ray, _, _, lane = sample_rays(scene, 5, 2)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    return pack_scene_bvh(scene), lane, ray, active


def test_megakernel_matches_plain(cuda_inputs):
    args, kw = cuda_inputs
    before = megakernel_trace.launches
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel_trace.launches == before + 1
    assert_lanes_close(got, megakernel_trace_plain(*args, **kw))


def test_megakernel_smooth_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = big_scene(32, 32, subdiv=2, device="cuda")   # 356 faces
    ray, _, _, lane = sample_rays(scene, 5, 2)
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, 5)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights,
              smooth=True)
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert_lanes_close(got, megakernel_trace_plain(*args, **kw))


def test_megakernel_rejects_bad_inputs(cuda_inputs):
    args, kw = cuda_inputs
    lane64 = args[2].to(torch.int64)
    with pytest.raises(ValueError):
        megakernel_trace(*args[:2], lane64, *args[3:], **kw)


def test_bounce_bvh_matches_plain(bvh_inputs):
    tables, lane, ray, active = bvh_inputs
    got = primary_state(ray.o, ray.d, active)
    ref = got.clone()
    before = megakernel_bounce_bvh.launches
    for depth in range(6):
        megakernel_bounce_bvh(tables, lane, 5, got, depth, 6, 5, smooth=True)
        ref = megakernel_bounce_bvh_plain(tables, lane, 5, ref, depth, 6, 5,
                                          smooth=True)
    torch.cuda.synchronize()
    assert megakernel_bounce_bvh.launches == before + 6
    assert_lanes_close(got[6:9].T, ref[6:9].T)


def test_trace_bvh_matches_plain(bvh_inputs):
    tables, lane, ray, active = bvh_inputs
    before = megakernel_trace_bvh.launches
    got = megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, 5, 6, 5,
                               smooth=True)
    torch.cuda.synchronize()
    assert megakernel_trace_bvh.launches == before + 1
    assert_lanes_close(got, megakernel_trace_bvh_plain(
        tables, lane, ray.o, ray.d, active, 5, 6, 5, smooth=True))


def test_bvh_kernels_reject_bad_inputs(bvh_inputs):
    tables, lane, ray, active = bvh_inputs
    with pytest.raises(ValueError):
        megakernel_bounce_bvh(tables, lane, 5,
                              primary_state(ray.o, ray.d, active).T, 0, 6, 5)
    with pytest.raises(ValueError):
        megakernel_trace_bvh(tables, lane.long(), ray.o, ray.d, active, 5,
                             6, 5)
    with pytest.raises(ValueError):
        megakernel_bounce_bvh(tables, lane, 5,
                              primary_state(ray.o, ray.d, active), 0, 6, 5,
                              btypes=(0, 24))


def test_intersect_packed_matches_plain(cuda_inputs):
    (_, _, lane, o, d, _, _), _ = cuda_inputs
    scene = cornell_box(32, 32, device="cuda")
    v, f = scene.geometry()[:2]
    tris = pack_triangles(v, f)
    active = lane % 5 != 0
    for maxt in (torch.full_like(o[:, 0], float("inf")), random_maxt(o)):
        before = intersect_packed.launches
        got = intersect_packed(tris, o, d, maxt, active)
        torch.cuda.synchronize()
        assert intersect_packed.launches == before + 1
        ref = intersect_packed_plain(tris, o, d, maxt, active)
        assert_hits_agree(got[0], got[1], ref[0], ref[1])
        assert (got[1][~active] == -1).all()


def test_traversal_matches_plain(bvh_inputs):
    tables, lane, ray, active = bvh_inputs
    active = active & (lane % 5 != 0)
    maxt = random_maxt(ray.o)
    before = packet_closest_hit.launches, packet_any_hit.launches
    t, face = packet_closest_hit(tables, ray.o, ray.d, maxt, active)
    occ = packet_any_hit(tables, ray.o, ray.d, maxt, active)
    torch.cuda.synchronize()
    assert (packet_closest_hit.launches, packet_any_hit.launches) == (
        before[0] + 1, before[1] + 1)
    t_ref, face_ref = packet_closest_hit_plain(tables, ray.o, ray.d, maxt,
                                               active)
    assert_hits_agree(t, face, t_ref, face_ref)
    occ_ref = packet_any_hit_plain(tables, ray.o, ray.d, maxt, active)
    assert (occ == occ_ref).float().mean() >= 0.9999
    assert not occ[~active].any()


def hold_hit_kernels(tables, o, d, maxt, active, route):
    """Both hit kernels against their plain versions on one launch each,
    which must take ``route``."""
    before = dict(packet_closest_hit.routes), dict(packet_any_hit.routes)
    t, face = packet_closest_hit(tables, o, d, maxt, active)
    occ = packet_any_hit(tables, o, d, maxt, active)
    torch.cuda.synchronize()
    assert packet_closest_hit.routes[route] == before[0][route] + 1
    assert packet_any_hit.routes[route] == before[1][route] + 1
    assert_hits_agree(t, face, *packet_closest_hit_plain(tables, o, d, maxt,
                                                         active))
    occ_ref = packet_any_hit_plain(tables, o, d, maxt, active)
    assert (occ == occ_ref).float().mean() >= 0.9999
    assert not occ[~active].any() and (face[~active] == -1).all()
    assert torch.isinf(t[~active]).all()
    return t, face, occ


@pytest.mark.parametrize("finite_maxt", [False, True])
def test_hit_kernels_masked_match_plain(bvh_inputs, finite_maxt):
    """#5 and #6 on the pair route with an 80 % mask: the plain
    versions' bar, and a second launch and a launch on permuted rays give
    every ray's outputs bit for bit."""
    tables, lane, ray, active = bvh_inputs
    n = int(lane.shape[0])
    g = torch.Generator(device=lane.device).manual_seed(3)
    active = torch.rand(n, generator=g, device=lane.device) < 0.8
    maxt = random_maxt(ray.o) if finite_maxt else torch.full(
        (n,), float("inf"), device=lane.device)
    assert tv.launch_config(n, tables.depth)["route"] == "pair"
    t, face, occ = hold_hit_kernels(tables, ray.o, ray.d, maxt, active,
                                    "pair")
    perm = torch.randperm(n, generator=g, device=lane.device)
    for p in (torch.arange(n, device=lane.device), perm):
        args = (tables, ray.o[p], ray.d[p], maxt[p], active[p])
        t2, face2 = packet_closest_hit(*args)
        assert same_bits(t2, t[p]) and torch.equal(face2, face[p])
        assert torch.equal(packet_any_hit(*args), occ[p])


def test_hit_kernels_deep_tree_route():
    """A tree deeper than the pair walk's stack (the Cornell box plus
    nested clusters) takes the miss-link route, held by the same bars;
    the shallow tree forced onto that route gives the same outputs as the
    pair route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = cornell_box(32, 32, device="cuda")
    v, f = nested_clusters()
    cluster = Mesh.make(v, f, bsdf_index=0, id="clusters", device="cuda")
    scene = make_scene(list(base.meshes) + [cluster], base.bsdfs,
                       base.emitters, base.sensor, base.device)
    tables = pack_scene_bvh(scene)
    assert tables.depth > tv.PAIR_STACK
    for kernel in ("closest", "any"):
        assert tv.launch_config(1, tables.depth, kernel)["route"] \
            == "miss_link"
    ray, _, _, lane = sample_rays(scene, 5, 4)
    active = lane % 5 != 0
    for maxt in (torch.full(lane.shape, float("inf"), device="cuda"),
                 random_maxt(ray.o)):
        hold_hit_kernels(tables, ray.o, ray.d, maxt, active, "miss_link")


def test_hit_stack_cap_constant():
    """The Python PAIR_STACK that routes the hit kernels is the walk's
    own, and both kernels route on it: the pair walk up to the cap, the
    miss-link walk beyond."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for kernel in ("closest", "any"):
        cfg = tv.launch_config(1, tv.PAIR_STACK, kernel)
        assert cfg["stack_cap"] == tv.PAIR_STACK == mkb.STACK_CAP
        assert cfg["route"] == tv.route_for(tv.PAIR_STACK) == "pair"
        assert tv.launch_config(1, tv.PAIR_STACK + 1, kernel)["route"] \
            == tv.route_for(tv.PAIR_STACK + 1) == "miss_link"


def test_hit_kernels_rounding_case():
    """On the tree built so that the two walks part, each route gives its
    eager twin's answer bit for bit: the pair route ``bvh.pair_walk``'s,
    the miss-link route ``bvh.walk``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree, rows, o, d = rounding_tree("cuda")
    tables = tv.pack_bvh_geometry(tree, rows)
    n = int(o.shape[0])
    maxt = torch.full((n,), float("inf"), device="cuda")
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    deep = dataclasses.replace(tables, depth=tv.PAIR_STACK + 1)
    for tabs, walk in ((tables, bvh.pair_walk), (deep, bvh.walk)):
        t, face = packet_closest_hit(tabs, o, d, maxt, active)
        t_ref, slot = walk(tree, tables.leaf_geo, o, d, maxt, active)
        assert same_bits(t, t_ref)
        assert torch.equal(face.long(), tree.prims.long()[slot])
    t_pair = packet_closest_hit(tables, o, d, maxt, active)[0]
    assert not torch.equal(t_pair, packet_closest_hit(deep, o, d, maxt,
                                                      active)[0])


def test_path_integrator_matches_megakernel(cuda_inputs):
    """The wavefront path over the CUDA intersect_packed against the
    megakernel on the same rays: one estimator, one RNG stream."""
    (tris, light, lane, o, d, active, seed), kw = cuda_inputs
    scene = cornell_box(32, 32, device="cuda")
    ray, _, _, _ = sample_rays(scene, 5, 4)
    before = intersect_packed.launches
    got = PathIntegrator(6, 5).sample(scene, ray, lane, seed, active)
    torch.cuda.synchronize()
    assert 0 < intersect_packed.launches - before <= 12
    assert_lanes_close(got, MegakernelPathIntegrator(6, 5).sample(
        scene, ray, lane, seed, active))


def _mask(kind, n, n_faces, device):
    """chip_smoke.py phase 4a's synthetic masks, seeded: a bool mask whose
    length is the number of rays.  A chunk (the slots a block compacts at
    a time) and a batch (the queued rays a block traces at once, one a
    thread) are the kernel's own, from ``launch_config``."""
    grid = ip.launch_config(n_faces, n)
    chunk, batch = grid["chunk"], grid["threads"]
    g = torch.Generator(device=device).manual_seed(7)
    half = torch.rand(n, generator=g, device=device) < 0.5
    return {"all": torch.ones(n, dtype=torch.bool, device=device),
            "tenth": torch.rand(n, generator=g, device=device) < 0.1,
            "none": torch.zeros(n, dtype=torch.bool, device=device),
            "n1": torch.ones(1, dtype=torch.bool, device=device),
            "chunk-1": half[:chunk - 1], "chunk+1": half[:chunk + 1],
            "batch-1": half[:batch - 1], "batch+1": half[:batch + 1]}[kind]


@pytest.mark.parametrize("kind", ["all", "tenth", "none", "n1", "chunk-1",
                                  "chunk+1", "batch-1", "batch+1"])
def test_intersect_packed_masks(cuda_inputs, kind):
    """The compacting kernel equals its plain version bit for bit (t,
    prim, u, v of every ray) under each mask, on the middle rays of the
    frame (where most hit), at maxt = inf and finite."""
    (_, _, _, o, d, _, _), _ = cuda_inputs
    scene = cornell_box(32, 32, device="cuda")
    tris = pack_triangles(*scene.geometry()[:2])
    active = _mask(kind, int(o.shape[0]), int(tris.shape[1]), o.device)
    n, k = int(o.shape[0]), int(active.shape[0])
    mid = slice((n - k) // 2, (n - k) // 2 + k)
    o, d = o[mid].contiguous(), d[mid].contiguous()
    g = torch.Generator(device=o.device).manual_seed(1)
    # primary hits of the Cornell box lie at t of about 3 to 5
    for maxt in (torch.full((k,), float("inf"), device=o.device),
                 8.0 * torch.rand(k, generator=g, device=o.device)):
        got = intersect_packed(tris, o, d, maxt, active)
        ref = intersect_packed_plain(tris, o, d, maxt, active)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_megakernel_schedule_invariant():
    """The persistent megakernel's lanes do not depend on the schedule, at
    a size where every thread takes several lanes in turn: two launches
    agree bit for bit, so does a launch on permuted lanes after
    un-permuting, inactive lanes give exactly 0, and the lanes hold the
    plain version's bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = cornell_box(32, 32, device="cuda")
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    grid = mk.launch_config(n_faces, n_lights, 1 << 30)
    spp = -(-4 * grid["blocks"] * grid["threads"] // (32 * 32))
    ray, _, _, lane = sample_rays(scene, 5, spp)
    o, d = ray.o, ray.d
    n = int(lane.shape[0])
    assert n >= 4 * grid["blocks"] * grid["threads"]
    active = torch.ones(n, dtype=torch.bool, device=lane.device)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights)
    args = (tris, light, lane, o, d, active, 5)
    first = megakernel_trace(*args, **kw)
    assert torch.equal(megakernel_trace(*args, **kw), first)
    g = torch.Generator(device=lane.device).manual_seed(7)
    perm = torch.randperm(n, generator=g, device=lane.device)
    permuted = megakernel_trace(tris, light, lane[perm], o[perm], d[perm],
                                active[perm], 5, **kw)
    assert torch.equal(permuted, first[perm])
    some = torch.rand(n, generator=g, device=lane.device) >= 0.1
    masked = megakernel_trace(tris, light, lane, o, d, some, 5, **kw)
    assert (masked[~some] == 0).all()
    assert torch.equal(masked[some], first[some])
    assert_lanes_close(first, megakernel_trace_plain(*args, **kw))


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_trace_bvh_schedule_invariant():
    """The persistent BVH megakernel's lanes do not depend on the schedule,
    at a size where every thread takes at least 4 lanes in turn (the frame
    sized from launch_config): two launches agree bit for bit, so does a
    launch on permuted lanes after un-permuting, inactive lanes give
    exactly 0, and the lanes hold the plain version's bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = big_scene(32, 32, subdiv=4, device="cuda")
    tables = pack_scene_bvh(scene)
    grid = mkb.launch_config("trace", 1 << 30)
    spp = -(-4 * grid["blocks"] * grid["threads"] // (32 * 32))
    ray, _, _, lane = sample_rays(scene, 5, spp)
    o, d = ray.o, ray.d
    n = int(lane.shape[0])
    assert n >= 4 * grid["blocks"] * grid["threads"]
    assert tables.depth <= grid["stack_cap"]
    active = torch.ones(n, dtype=torch.bool, device=lane.device)
    kw = dict(max_depth=6, rr_depth=5, smooth=True)
    first = megakernel_trace_bvh(tables, lane, o, d, active, 5, **kw)
    assert same_bits(megakernel_trace_bvh(tables, lane, o, d, active, 5,
                                          **kw), first)
    g = torch.Generator(device=lane.device).manual_seed(7)
    perm = torch.randperm(n, generator=g, device=lane.device)
    permuted = megakernel_trace_bvh(tables, lane[perm], o[perm], d[perm],
                                    active[perm], 5, **kw)
    assert same_bits(permuted, first[perm])
    some = torch.rand(n, generator=g, device=lane.device) >= 0.1
    masked = megakernel_trace_bvh(tables, lane, o, d, some, 5, **kw)
    assert (masked[~some] == 0).all()
    assert same_bits(masked[some], first[some])
    assert_lanes_close(first, megakernel_trace_bvh_plain(
        tables, lane, o, d, active, 5, **kw))


def test_bounce_bvh_schedule_invariant(bvh_inputs):
    """The persistent bounce kernel, at each depth, gives the same state
    bit for bit on a clone of its input and on a permutation of its lanes
    (un-permuted)."""
    tables, lane, ray, active = bvh_inputs
    state = primary_state(ray.o, ray.d, active)
    n = int(lane.shape[0])
    g = torch.Generator(device=lane.device).manual_seed(7)
    for depth in range(6):
        before = state.clone()
        megakernel_bounce_bvh(tables, lane, 5, state, depth, 6, 5, smooth=True)
        again = megakernel_bounce_bvh(tables, lane, 5, before.clone(), depth,
                                      6, 5, smooth=True)
        perm = torch.randperm(n, generator=g, device=lane.device)
        permuted = megakernel_bounce_bvh(tables, lane[perm], 5,
                                         before[:, perm].contiguous(), depth,
                                         6, 5, smooth=True)
        torch.cuda.synchronize()
        assert same_bits(again, state)
        assert same_bits(permuted, state[:, perm])


def test_bvh_kernels_reject_deep_tree(bvh_inputs):
    """A tree deeper than the walk's stack cap is refused, not walked."""
    tables, lane, ray, active = bvh_inputs
    cap = mkb.launch_config("trace", 1)["stack_cap"]
    assert 0 < tables.depth <= cap
    deep = dataclasses.replace(tables, depth=cap + 1)
    before = (megakernel_bounce_bvh.launches, megakernel_trace_bvh.launches)
    with pytest.raises(ValueError):
        megakernel_trace_bvh(deep, lane, ray.o, ray.d, active, 5, 6, 5)
    with pytest.raises(ValueError):
        megakernel_bounce_bvh(deep, lane, 5,
                              primary_state(ray.o, ray.d, active), 0, 6, 5)
    assert (megakernel_bounce_bvh.launches,
            megakernel_trace_bvh.launches) == before


def lobe_scene(base, assign):
    """``base`` with BSDFs appended and meshes re-pointed at them:
    ``assign`` maps a mesh index to the new BSDF (Cu conductors, eta 1.5,
    alpha 0.2)."""
    dev = base.device
    cu = [torch.tensor(x, device=dev) for x in CONDUCTOR_IOR["Cu"]]
    eta, alpha = torch.tensor(1.5, device=dev), torch.tensor(0.2, device=dev)
    made = {"conductor": lambda: SmoothConductor(eta=cu[0], k=cu[1]),
            "dielectric": lambda: SmoothDielectric(eta=eta),
            "roughconductor": lambda: RoughConductor(eta=cu[0], k=cu[1],
                                                     alpha=alpha),
            "roughdielectric": lambda: RoughDielectric(eta=eta, alpha=alpha)}
    bsdfs, meshes = list(base.bsdfs), list(base.meshes)
    for mesh, kind in assign.items():
        meshes[mesh] = dataclasses.replace(meshes[mesh],
                                           bsdf_index=len(bsdfs))
        bsdfs.append(made[kind]())
    return make_scene(meshes, bsdfs, base.emitters, base.sensor, dev)


# every ported lobe on the Cornell box: the boxes rough, two walls smooth
CORNELL_LOBES = {6: "roughconductor", 7: "roughdielectric", 4: "conductor",
                 5: "dielectric"}


def test_lobe_megakernel_matches_plain():
    """megakernel_trace's lobe build on the Cornell box with every ported
    lobe, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = lobe_scene(cornell_box(32, 32, device="cuda"), CORNELL_LOBES)
    assert mk.megakernel_applicable(scene)
    ray, _, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, 5)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights,
              btypes=scene_btypes(scene))
    before = megakernel_trace.launches
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel_trace.launches == before + 1
    assert_lanes_close(got, megakernel_trace_plain(*args, **kw))


def test_lobe_bvh_kernels_match_plain():
    """Both BVH kernels' lobe builds on big_scene(subdiv=4) with the ball
    a rough dielectric and the small box a smooth conductor, against their
    plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = big_scene(32, 32, subdiv=4, device="cuda")
    scene = lobe_scene(base, {len(base.meshes) - 1: "roughdielectric",
                              6: "conductor"})
    btypes = scene_btypes(scene)
    assert btypes == (0, 1, 4) and mkb.megakernel_bvh_applicable(scene)
    tables = pack_scene_bvh(scene)
    ray, _, _, lane = sample_rays(scene, 5, 2)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    kw = dict(smooth=True, btypes=btypes)
    got = primary_state(ray.o, ray.d, active)
    ref = got.clone()
    for depth in range(6):
        megakernel_bounce_bvh(tables, lane, 5, got, depth, 6, 5, **kw)
        ref = megakernel_bounce_bvh_plain(tables, lane, 5, ref, depth, 6, 5,
                                          **kw)
    trace = megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, 5, 6, 5,
                                 **kw)
    torch.cuda.synchronize()
    assert_lanes_close(got[6:9].T, ref[6:9].T)
    assert_lanes_close(trace, megakernel_trace_bvh_plain(
        tables, lane, ray.o, ray.d, active, 5, 6, 5, **kw))


def test_stack_cap_constant():
    """The Python STACK_CAP that gates the BVH kernels is the walk's own,
    for both kernels and every build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for kernel in ("trace", "bounce"):
        for btypes in ((0,), (0, 1, 2, 3, 4), (0, 6, 7, 16)):
            assert mkb.launch_config(kernel, 1, btypes)["stack_cap"] \
                == mkb.STACK_CAP


def test_deep_bvh_falls_back():
    """A scene whose BVH is deeper than the walk takes (the Cornell box
    plus 1,000 triangles in 40 nested clusters) renders through the
    wavefront path and its stackless walk: no megakernel launches, and
    the image is the PathIntegrator's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = cornell_box(32, 32, device="cuda")
    v, f = nested_clusters()
    cluster = Mesh.make(v, f, bsdf_index=0, id="clusters", device="cuda")
    scene = make_scene(list(base.meshes) + [cluster], base.bsdfs,
                       base.emitters, base.sensor, base.device)
    assert scene.accel.depth > mkb.STACK_CAP
    before = (megakernel_bounce_bvh.launches, megakernel_trace_bvh.launches,
              packet_closest_hit.launches)
    image = render(scene, MegakernelPathIntegrator(6, 5), seed=1, spp=2)
    torch.cuda.synchronize()
    assert (megakernel_bounce_bvh.launches,
            megakernel_trace_bvh.launches) == before[:2]
    assert packet_closest_hit.launches > before[2]
    assert torch.isfinite(image).all() and image.mean() > 0
    torch.testing.assert_close(image, render(scene, PathIntegrator(6, 5),
                                             seed=1, spp=2), rtol=0, atol=0)


SURFACE_CORNELLS = {"plastic": plastic_cornell, "twosided": twosided_cornell,
                    "textured": textured_cornell}


@pytest.mark.parametrize("kind", sorted(SURFACE_CORNELLS))
def test_surface_megakernel_matches_plain(kind):
    """megakernel_trace's surface build on the plastic, two-sided and
    textured Cornell boxes, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = SURFACE_CORNELLS[kind](32, 32, device="cuda")
    assert mk.megakernel_applicable(scene)
    btypes = scene_btypes(scene)
    assert mk.lobes_flag(btypes) == 2
    ray, _, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights, tex, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, 5)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights,
              btypes=btypes, tex=tex)
    before = megakernel_trace.launches
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel_trace.launches == before + 1
    assert_lanes_close(got, megakernel_trace_plain(*args, **kw))


def test_textured_megakernel_schedule_invariant():
    """The surface build reads the texture arena the same way whatever
    thread takes a lane: a second launch and a launch on permuted lanes
    give every lane the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = textured_cornell(64, 64, device="cuda")
    ray, _, _, lane = sample_rays(scene, 5, 8)
    tris, light, n_faces, n_lights, tex, _ = pack_scene(scene)
    n = int(lane.shape[0])
    active = torch.ones(n, dtype=torch.bool, device=lane.device)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights,
              btypes=scene_btypes(scene), tex=tex)
    first = megakernel_trace(tris, light, lane, ray.o, ray.d, active, 5, **kw)
    assert same_bits(megakernel_trace(tris, light, lane, ray.o, ray.d,
                                      active, 5, **kw), first)
    g = torch.Generator(device=lane.device).manual_seed(7)
    perm = torch.randperm(n, generator=g, device=lane.device)
    permuted = megakernel_trace(tris, light, lane[perm], ray.o[perm],
                                ray.d[perm], active[perm], 5, **kw)
    assert same_bits(permuted, first[perm])


@pytest.mark.parametrize("textured", [False, True])
def test_surface_bvh_kernels_match_plain(textured):
    """The BVH kernels' surface builds on surfaces_big_scene(subdiv=4)
    (a rough-plastic ball, a two-sided Cu box; the textured twin's ball
    under a bitmap) against their plain versions: the bounce kernel on
    both, the single launch on the untextured one, which it alone takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = surfaces_big_scene(32, 32, subdiv=4, textured=textured,
                               device="cuda")
    btypes = scene_btypes(scene)
    assert btypes == ((0, 5, 17) if textured else (0, 7, 17))
    assert mkb.megakernel_bvh_applicable(scene)
    tables = pack_scene_bvh(scene)
    ray, _, _, lane = sample_rays(scene, 5, 2)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    kw = dict(smooth=True, btypes=btypes)
    got = primary_state(ray.o, ray.d, active)
    ref = got.clone()
    for depth in range(6):
        megakernel_bounce_bvh(tables, lane, 5, got, depth, 6, 5, **kw)
        ref = megakernel_bounce_bvh_plain(tables, lane, 5, ref, depth, 6, 5,
                                          **kw)
    torch.cuda.synchronize()
    assert_lanes_close(got[6:9].T, ref[6:9].T)
    if textured:
        with pytest.raises(ValueError, match="textured"):
            megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, 5, 6, 5,
                                 **kw)
        return
    trace = megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, 5, 6, 5,
                                 **kw)
    torch.cuda.synchronize()
    assert_lanes_close(trace, megakernel_trace_bvh_plain(
        tables, lane, ray.o, ray.d, active, 5, 6, 5, **kw))


def test_surface_build_equals_lobe_build():
    """On a scene of codes 0-4 the surface build computes what the lobe
    build does, bit for bit (it only adds branches), so running the
    config-2 scenes through it would change no lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = lobe_scene(cornell_box(32, 32, device="cuda"), CORNELL_LOBES)
    ray, _, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, 5)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights)
    lobe = megakernel_trace(*args, btypes=scene_btypes(scene), **kw)
    # code 6 in btypes selects the surface build; no face carries it
    surface = megakernel_trace(*args, btypes=scene_btypes(scene) + (6,),
                               **kw)
    assert same_bits(surface, lobe)


# ---------------------------------------------------------- environment maps

@pytest.mark.parametrize("area_light", [False, True])
def test_envmap_megakernel_matches_plain(area_light):
    """megakernel_trace's environment builds on envmap_scene under the
    2048 x 1024 sky: the envmap alone (no light faces; the diffuse-only
    body) and with the area light and a rough Cu ball (the surface body),
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = envmap_scene(32, 32, area_light=area_light, device="cuda")
    assert mk.megakernel_applicable(scene)
    btypes = scene_btypes(scene)
    ray, _, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights, tex, env = pack_scene(scene)
    assert n_lights == (2 if area_light else 0)
    assert env["env_pos"] == (1 if area_light else 0)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, 5)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights,
              btypes=btypes, tex=tex, smooth=True, **env)
    before = megakernel_trace.launches
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel_trace.launches == before + 1
    assert_lanes_close(got, megakernel_trace_plain(*args, **kw))


@pytest.mark.parametrize("area_light", [False, True])
def test_envmap_bounce_bvh_matches_plain(area_light):
    """megakernel_bounce_bvh's environment builds on
    envmap_big_scene(subdiv=4) (a 5,120-face ball) at every depth against
    its plain version; megakernel_trace_bvh refuses the environment map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = envmap_big_scene(32, 32, area_light=area_light, subdiv=4,
                             device="cuda")
    assert mkb.megakernel_bvh_applicable(scene)
    tables = pack_scene_bvh(scene)
    assert tables.env_pos == (1 if area_light else 0)
    ray, _, _, lane = sample_rays(scene, 5, 2)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    kw = dict(smooth=True, btypes=scene_btypes(scene))
    got = primary_state(ray.o, ray.d, active)
    ref = got.clone()
    before = megakernel_bounce_bvh.launches
    for depth in range(6):
        megakernel_bounce_bvh(tables, lane, 5, got, depth, 6, 5, **kw)
        ref = megakernel_bounce_bvh_plain(tables, lane, 5, ref, depth, 6, 5,
                                          **kw)
        torch.cuda.synchronize()
        assert_lanes_close(got[6:9].T, ref[6:9].T)
    assert megakernel_bounce_bvh.launches == before + 6
    with pytest.raises(ValueError, match="environment"):
        megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, 5, 6, 5,
                             **kw)


def test_envmap_megakernel_schedule_invariant():
    """The environment builds draw each lane's NEE candidate and escape
    from (seed, lane, dim) alone: a second launch and a launch on
    permuted lanes give every lane the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = envmap_scene(64, 64, area_light=True, device="cuda")
    ray, _, _, lane = sample_rays(scene, 5, 8)
    tris, light, n_faces, n_lights, tex, env = pack_scene(scene)
    n = int(lane.shape[0])
    active = torch.ones(n, dtype=torch.bool, device=lane.device)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights,
              btypes=scene_btypes(scene), tex=tex, smooth=True, **env)
    first = megakernel_trace(tris, light, lane, ray.o, ray.d, active, 5, **kw)
    assert same_bits(megakernel_trace(tris, light, lane, ray.o, ray.d,
                                      active, 5, **kw), first)
    g = torch.Generator(device=lane.device).manual_seed(7)
    perm = torch.randperm(n, generator=g, device=lane.device)
    permuted = megakernel_trace(tris, light, lane[perm], ray.o[perm],
                                ray.d[perm], active[perm], 5, **kw)
    assert same_bits(permuted, first[perm])



def _prb_gradients(device, width, spp):
    """PRB gradients of a seeded weighted sum of the image with respect to
    the textured Cornell box's back-wall texels and red-wall albedo."""
    from mitsuba_tpu_torch import PRBIntegrator, prb_render
    from mitsuba_tpu_torch.utils.params import traverse, update

    scene = textured_cornell(width, width, device=device)
    keys = ("bsdfs.3.reflectance.data", "bsdfs.2.reflectance.value")
    leaves = {k: traverse(scene)[k].clone().requires_grad_() for k in keys}
    w = torch.rand((width, width, 3),
                   generator=torch.Generator().manual_seed(3)).to(device)
    img = prb_render(update(scene, leaves), PRBIntegrator(6, 5), 7, spp,
                     device=device)
    torch.sum(img * w).backward()
    return {k: v.grad.cpu() for k, v in leaves.items()}


def test_prb_gradients_match_cpu():
    """PRB on the card (intersect_packed) against the plain route on the
    CPU at 16x16 x 4 spp: every gradient finite and within 1e-3 in
    relative norm (the texture's backward adds texels in another order
    on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = intersect_packed.launches
    got = _prb_gradients("cuda", 16, 4)
    assert intersect_packed.launches > before
    want = _prb_gradients("cpu", 16, 4)
    for k in want:
        assert torch.isfinite(got[k]).all()
        err = torch.linalg.norm(got[k] - want[k]) / torch.linalg.norm(want[k])
        assert err <= 1e-3, (k, float(err))


def test_adam_step_on_card():
    """One Adam step and one SGD step with momentum on the card equal the
    same steps on the CPU (1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch.utils.optimizers import SGD, Adam

    g = torch.Generator().manual_seed(5)
    params = {"a": torch.rand(3, generator=g),
              "b": torch.rand((64, 64, 3), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    for opt in (Adam(lr=0.05), SGD(lr=0.1, momentum=0.9)):
        out = {}
        for dev in ("cuda", "cpu"):
            p = {k: v.to(dev) for k, v in params.items()}
            out[dev] = opt.step(p, {k: v.to(dev) for k, v in grads.items()},
                                opt.init(p))[0]
        for k in params:
            assert out["cuda"][k].device.type == "cuda"
            torch.testing.assert_close(out["cuda"][k].cpu(), out["cpu"][k],
                                       rtol=1e-6, atol=1e-6)


def _moved_ball(device):
    """big_scene(16, 16, subdiv=3) with its ball moved by -0.5 in x through
    ``update``, no rebuild: the tree is refitted at the render."""
    from mitsuba_tpu_torch.utils.params import traverse, update

    scene = big_scene(16, 16, subdiv=3, device=device)
    v = traverse(scene)["meshes.8.vertices"]
    return update(scene, {"meshes.8.vertices": v + torch.tensor(
        [-0.5, 0.0, 0.0], device=device)})


def test_refit_on_card_matches_cpu():
    """The refit on the card gives the CPU's boxes and node_pair bit for
    bit, and #5 / #6 over the refitted tree the plain walks' hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trees, hits = {}, {}
    for dev in ("cuda", "cpu"):
        scene = _moved_ball(dev)
        trees[dev] = bvh.refit_bvh(scene.accel, scene.geometry()[0])
        ray, _, _, lane = sample_rays(scene, 3, 4)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        ctx = scene.trace_ctx()
        hits[dev] = (packet_closest_hit(ctx["bvh"], ray.o, ray.d, ray.maxt,
                                        active), ctx, ray, active)
    for name in ("bbox_lo", "bbox_hi"):
        assert torch.equal(getattr(trees["cuda"], name).cpu(),
                           getattr(trees["cpu"], name))
    assert torch.equal(trees["cuda"].node_pair.view(torch.int32).cpu(),
                       trees["cpu"].node_pair.view(torch.int32))
    (t, prim), ctx, ray, active = hits["cuda"]
    t_ref, prim_ref = packet_closest_hit_plain(ctx["bvh"], ray.o, ray.d,
                                               ray.maxt, active)
    assert_hits_agree(t, prim, t_ref, prim_ref)
    t_cpu, prim_cpu = hits["cpu"][0]
    assert_hits_agree(t.cpu(), prim.cpu(), t_cpu, prim_cpu)


def test_ptracer_on_card_matches_cpu():
    """The spectral particle tracer on a Cornell box with a dispersive
    small box, on the card (intersect_packed) and on the CPU: images
    within 1e-4 in relative norm (the splat adds in another order on the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch import ParticleTracerIntegrator
    from mitsuba_tpu_torch.models.bsdfs import DispersiveDielectric

    images = {}
    before = intersect_packed.launches
    for dev in ("cuda", "cpu"):
        base = cornell_box(16, 16, device=dev)
        glass = DispersiveDielectric(*(torch.tensor(x, device=dev)
                                       for x in (1.6, 20.0, 1.0, 0.0)))
        meshes = list(base.meshes)
        meshes[6] = dataclasses.replace(meshes[6], bsdf_index=len(base.bsdfs))
        scene = make_scene(meshes, list(base.bsdfs) + [glass], base.emitters,
                           base.sensor, dev)
        images[dev] = render(scene, ParticleTracerIntegrator(6, 3,
                                                             spectral=True),
                             5, 16, device=dev).cpu()
        if dev == "cuda":
            assert intersect_packed.launches > before
    assert torch.isfinite(images["cuda"]).all()
    err = torch.linalg.norm(images["cuda"] - images["cpu"]) \
        / torch.linalg.norm(images["cpu"])
    assert err <= 1e-4, float(err)


def test_design_step_on_card():
    """One Adam step of the doublet design on the card through
    intersect_packed: a finite loss and gradients, every parameter moved
    only by its learning rate, V_d toward the achromat's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch.examples.doublet_achromat_design import (
        build_doublet, exact_vd, make_problem)

    ls = build_doublet(n_rings=3, n_sectors=8, device="cuda")
    dp = make_problem(ls, spp=16, resolution=8, iters=1)
    before = intersect_packed.launches
    p0 = {k: float(v) for k, v in dp.params().items()}
    p = dp.optimize(lr_overrides={k: 0.0 for k in p0 if k != "mat_sf11_V_d"})
    assert intersect_packed.launches > before
    assert all(torch.isfinite(torch.tensor(x)) for x in dp.loss_history)
    for k, v in p.items():
        assert v.device.type == "cuda"
        if k != "mat_sf11_V_d":
            assert float(v) == p0[k], k
    vd0, vd1 = p0["mat_sf11_V_d"], float(p["mat_sf11_V_d"])
    assert abs(vd1 - exact_vd(ls)) < abs(vd0 - exact_vd(ls))


def _lens_cornell(device, size=32, **kw):
    """The Cornell box through a double Gauss with its exit-pupil table at
    16 segments of 4096 rays, focused at 3.9."""
    from mitsuba_tpu_torch import make_lens_camera

    base = cornell_box(size, size, device=device)
    cam = make_lens_camera("gauss", film=base.sensor.film,
                           to_world=base.sensor.to_world, focus_distance=3.9,
                           sample_exit_pupil=True, pupil_segments=16,
                           pupil_rays_per_segment=4096, device=device, **kw)
    return dataclasses.replace(base, sensor=cam)


def test_lens_sample_rays_on_card_matches_cpu():
    """The spectral double Gauss's primary rays on the card against the CPU
    route: the same lanes alive but for 0.5 %, the live ones per lane
    within 1e-4 (the card rounds a scalar division as a multiply)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = {}
    for dev in ("cuda", "cpu"):
        ray, w, _, _ = sample_rays(_lens_cornell(dev, spectral=True), 5, 4)
        out[dev] = [x.cpu() for x in (ray.o, ray.d, ray.wavelengths, w)]
    alive = {k: v[3].amax(-1) > 0 for k, v in out.items()}
    assert (alive["cuda"] != alive["cpu"]).float().mean() <= 5e-3
    both = alive["cuda"] & alive["cpu"]
    assert both.float().mean() > 0.3
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got[both], want[both], rtol=1e-4,
                                   atol=1e-6)


def test_megakernel_on_lens_rays_matches_plain():
    """#2 on the double Gauss's rays (origins spread over the front
    element, vignetted lanes parked with weight 0) against its plain
    version, and every lane's film contribution finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _lens_cornell("cuda")
    ray, w, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    args = (tris, light, lane, ray.o, ray.d, active, 5)
    kw = dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights)
    before = megakernel_trace.launches
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel_trace.launches == before + 1
    assert (w.amax(-1) == 0).any()
    assert torch.isfinite(got * w).all()
    assert_lanes_close(got, megakernel_trace_plain(*args, **kw))


def test_exit_pupil_lut_on_card_matches_cpu():
    """The double Gauss's exit-pupil table traced on the card against the
    CPU route: each box within the rays' spacing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    from mitsuba_tpu_torch.lens import compute_exit_pupil_lut

    luts = {dev: compute_exit_pupil_lut(_lens_cornell(dev).sensor, 64, 16384)
            for dev in ("cuda", "cpu")}
    cam = _lens_cornell("cpu").sensor
    spacing = 4.0 * 1.5 * float(cam.rear_radius) * math.sqrt(2.0 / 16384)
    for got, want in zip(luts["cuda"], luts["cpu"]):
        assert (got.cpu() - want).abs().max() <= spacing


def _quad_x_grad(render, device, *args, dx=0.0, spp=64):
    """d sum(img * x ramp) / d(quad x) at dx through ``render``."""
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.scenes import emissive_quad

    scene = emissive_quad(32, 32, dx, device=device)
    w = (torch.arange(32, dtype=torch.float32, device=scene.device)
         / 32.0)[None, :, None].expand(32, 32, 3)
    v = traverse(scene)["meshes.0.vertices"].clone().requires_grad_()
    img = render(update(scene, {"meshes.0.vertices": v}), *args, 0, spp,
                 device=device)
    torch.sum(img * w).backward()
    return float(v.grad[:, 0].sum()), float(torch.sum(img.detach() * w))


def test_projective_quad_matches_fd():
    """tests/test_projective.py's acceptance case on the card: the quad's
    x-translation gradient through prb_projective_render (32x32, spp 64,
    sppp 8192, n_sub 2, depth 2) within 0.25 |fd| + 0.05 of central
    differences (h = 0.04); PRB alone under 0.25 |fd|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch import (PathProjectiveIntegrator, PRBIntegrator,
                                   build_silhouette_edges,
                                   prb_projective_render, prb_render)
    from mitsuba_tpu_torch.utils.scenes import emissive_quad

    edges = build_silhouette_edges(emissive_quad(32, 32, device="cuda"))
    integ = PathProjectiveIntegrator(max_depth=2, sppp=8192, n_sub=2,
                                     indirect=False)
    before = intersect_packed.launches
    ad, _ = _quad_x_grad(prb_projective_render, "cuda", edges, integ)
    assert intersect_packed.launches > before
    h = 0.04
    fd = (_quad_x_grad(prb_projective_render, "cuda", edges, integ, dx=h)[1]
          - _quad_x_grad(prb_projective_render, "cuda", edges, integ,
                         dx=-h)[1]) / (2 * h)
    assert abs(ad - fd) < 0.25 * abs(fd) + 0.05, (ad, fd)
    ad0, _ = _quad_x_grad(prb_render, "cuda", PRBIntegrator(max_depth=2))
    assert abs(ad0) < 0.25 * abs(fd), (ad0, fd)


def _pose_gradient(device):
    """d sum(img * w) / d(camera translation) through prb_projective_render
    on the Cornell box at 16x16 x 4 spp, 1024 boundary samples."""
    from mitsuba_tpu_torch import (PathProjectiveIntegrator,
                                   build_silhouette_edges,
                                   prb_projective_render)
    from mitsuba_tpu_torch.utils.params import update

    scene = cornell_box(16, 16, device=device)
    t = torch.tensor([0.03, -0.02, 0.0], device=scene.device,
                     requires_grad=True)
    move = torch.eye(4, device=scene.device).index_put(
        (torch.arange(3), torch.full((3,), 3)), t)
    pose = move @ scene.sensor.to_world
    w = torch.rand((16, 16, 3),
                   generator=torch.Generator().manual_seed(3)).to(device)
    img = prb_projective_render(
        update(scene, {"sensor.to_world": pose}),
        build_silhouette_edges(scene),
        PathProjectiveIntegrator(max_depth=6, rr_depth=5, sppp=1024,
                                 indirect=False), 7, 4, device=device)
    torch.sum(img * w).backward()
    return t.grad.cpu()


def test_pose_gradient_card_matches_cpu():
    """The camera-pose gradient (PRB plus the primary boundary term) on
    the card against the plain route on the CPU: finite and within 1e-3
    in relative norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _pose_gradient("cuda")
    want = _pose_gradient("cpu")
    assert torch.isfinite(got).all() and float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) <= 1e-3, (got, want)


def _shadow_gradient(device):
    """d sum(img * x ramp) / d(blocker vertices) through
    prb_projective_render on utils/scenes.py's shadow_scene at 32x32 x 4
    spp, the shadow term on (16,384 samples, uniform)."""
    from mitsuba_tpu_torch import (PathProjectiveIntegrator,
                                   build_silhouette_edges,
                                   prb_projective_render)
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.scenes import shadow_scene

    scene = shadow_scene(32, 32, device=device)
    key = "meshes.1.vertices"
    b = traverse(scene)[key].clone().requires_grad_()
    w = (torch.arange(32, dtype=torch.float32, device=scene.device)
         / 32.0)[None, :, None].expand(32, 32, 3)
    img = prb_projective_render(
        update(scene, {key: b}), build_silhouette_edges(scene),
        PathProjectiveIntegrator(max_depth=2, sppp=1024, n_sub=1,
                                 sppi=16384), 7, 4, device=device)
    torch.sum(img * w).backward()
    return b.grad.cpu()


def test_shadow_gradient_card_matches_cpu():
    """The blocker's gradient, all shadow-boundary term (the blocker is
    outside the view), on the card against the plain route on the CPU:
    finite, nonzero and within 1e-3 in relative norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = intersect_packed.launches
    got = _shadow_gradient("cuda")
    assert intersect_packed.launches > before
    want = _shadow_gradient("cpu")
    assert torch.isfinite(got).all() and float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) <= 1e-3, (got, want)


# ------------------------------------------------- exact analytic prims

@pytest.mark.parametrize("sphere_light", [False, True])
def test_analytic_cornell_path_matches_plain_route(sphere_light):
    """The PathIntegrator on analytic_cornell (32x32 x 4) through
    intersect_packed, lane by lane against the same walk over the plain
    hit query on the card, with and without the sphere lamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import analytic_cornell

    scene = analytic_cornell(32, 32, sphere_light=sphere_light, device="cuda")
    ray, _, _, lane = sample_rays(scene, 5, 4)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    integ = PathIntegrator(6, 5)
    before = intersect_packed.launches
    got = integ.sample(scene, ray, lane, 5, active)
    assert intersect_packed.launches > before
    saved = scene_mod.intersect_packed
    scene_mod.intersect_packed = intersect_packed_plain
    try:
        ref = integ.sample(scene, ray, lane, 5, active)
    finally:
        scene_mod.intersect_packed = saved
    assert_lanes_close(got, ref)


def _analytic_gradient(device):
    """d sum(img * seeded weights) / d(the ball's centre and radius)
    through prb_projective_render on analytic_cornell at 32x32 x 4 spp
    (the analytic silhouettes and the shadow term on)."""
    from mitsuba_tpu_torch import (PathProjectiveIntegrator, analytic_cornell,
                                   build_silhouette_edges,
                                   prb_projective_render)
    from mitsuba_tpu_torch.utils.params import traverse, update

    scene = analytic_cornell(32, 32, device=device)
    keys = ("scene_analytic.sp_center", "scene_analytic.sp_radius")
    leaves = {k: traverse(scene)[k].clone().requires_grad_() for k in keys}
    w = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(7))
    img = prb_projective_render(
        update(scene, leaves), build_silhouette_edges(scene),
        PathProjectiveIntegrator(6, 5, sppp=1024, n_sub=1, sppi=4096), 7, 4,
        device=device)
    torch.sum(img * w.to(scene.device)).backward()
    return torch.cat([leaves[k].grad.reshape(-1).cpu() for k in keys])


def test_analytic_gradient_card_matches_cpu():
    """The ball's centre and radius gradients with the analytic
    silhouette term on the card against the plain route on the CPU:
    finite, nonzero and within 1e-3 in relative norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _analytic_gradient("cuda")
    want = _analytic_gradient("cpu")
    assert torch.isfinite(got).all() and float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) <= 1e-3, (got, want)


def test_largesteps_solve_repeats_on_card():
    """LargeSteps' Laplacian product, its CG solve and the solve's
    gradient give the same bits on every run on the card (the product
    adds each vertex's neighbours in a fixed order: an index_add's atomics
    would not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch import LargeSteps
    from mitsuba_tpu_torch.models.shapes import sphere_mesh

    v, f, _, _ = sphere_mesh(6)
    ls = LargeSteps(torch.tensor(v), torch.tensor(f), device="cuda")
    u = ls.to_differential(torch.tensor(v, device="cuda")
                           + 0.01 * torch.randn(len(v), 3, device="cuda"))
    w = torch.randn(len(v), 3, device="cuda")

    def run():
        leaf = u.clone().requires_grad_()
        out = ls.from_differential(leaf)
        torch.sum(out * w).backward()
        return ls._laplacian_matvec(u), out.detach(), leaf.grad

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


# --------------------- curves, SDF grids, instancing, repeatable gathers

def test_gather_rows_backward_repeats_on_card():
    """gather_rows' backward (segment_sum) on the card: two runs bit for
    bit on rows gathered by up to 200,000 lanes each, and within 1e-5 of
    the CPU's index_add relative to the largest row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch.ops.gather import gather_rows

    gen = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 5000, (400_000,), generator=gen)
    idx[:200_000] = 7
    x = torch.randn(5000, 26, generator=gen)
    w = torch.randn(400_000, 26, generator=gen)

    def run(dev):
        leaf = x.to(dev).requires_grad_()
        torch.sum(gather_rows(leaf, idx.to(dev)) * w.to(dev)).backward()
        return leaf.grad

    a, b, cpu = run("cuda"), run("cuda"), run("cpu")
    assert torch.equal(a, b)
    assert float((a.cpu() - cpu).abs().max()) <= 1e-5 * float(
        cpu.abs().max())


@pytest.mark.parametrize("kind", ["curves", "sdf", "instances"])
def test_new_shapes_path_matches_plain_route(kind):
    """The PathIntegrator (32x32 x 4) on curves_cornell, sdf_cornell and
    instanced_cornell(4 x 4, subdiv 4: the group through #5 / #6) through
    the kernels, lane by lane against the same walk over the plain hit
    queries on the card (the scene's and the group's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba_tpu_torch.models.instancing as inst_mod
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (curves_cornell, instanced_cornell,
                                   sdf_cornell)
    from mitsuba_tpu_torch.ops import traverse as tv

    scene = {"curves": lambda: curves_cornell(32, 32, device="cuda"),
             "sdf": lambda: sdf_cornell(32, 32, device="cuda"),
             "instances": lambda: instanced_cornell(32, 32, 4, 4, 4,
                                                    device="cuda")}[kind]()
    ray, _, _, lane = sample_rays(scene, 5, 4)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    integ = PathIntegrator(6, 5)
    got = integ.sample(scene, ray, lane, 5, active)
    names = {"intersect_packed": intersect_packed_plain,
             "packet_closest_hit": tv.packet_closest_hit_plain,
             "packet_any_hit": tv.packet_any_hit_plain}
    saved = [(m, n, getattr(m, n)) for m in (scene_mod, inst_mod)
             for n in names]
    for m, n, _ in saved:
        setattr(m, n, names[n])
    try:
        ref = integ.sample(scene, ray, lane, 5, active)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    assert_lanes_close(got, ref)


def _new_shape_gradients(device, width=32, spp=4):
    """prb_render gradients of sum(img * seeded weights) at width^2 x spp
    with respect to one instance's to_world, the SDF's values and the
    curve's control points, each on its scene."""
    from mitsuba_tpu_torch import (PRBIntegrator, curves_cornell,
                                   instanced_cornell, prb_render,
                                   sdf_cornell)
    from mitsuba_tpu_torch.utils.params import traverse, update

    out = {}
    for key, make in (("instances.0.to_world",
                       lambda: instanced_cornell(width, width, 4, 4, 4,
                                                 device=device)),
                      ("scene_sdf.values",
                       lambda: sdf_cornell(width, width, device=device)),
                      ("scene_analytic.cv_cp",
                       lambda: curves_cornell(width, width, device=device))):
        scene = make()
        leaf = traverse(scene)[key].clone().requires_grad_()
        w = torch.rand((width, width, 3),
                       generator=torch.Generator().manual_seed(7))
        img = prb_render(update(scene, {key: leaf}), PRBIntegrator(6, 5), 7,
                         spp, device=device)
        torch.sum(img * w.to(scene.device)).backward()
        out[key] = leaf.grad.cpu()
    return out


def test_new_shape_gradients_card_match_cpu_and_repeat():
    """The instance, SDF and curve gradients of prb_render on the card:
    within 1e-3 in relative norm of the CPU route's, and bit for bit on a
    second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = _new_shape_gradients("cuda"), _new_shape_gradients("cuda")
    cpu = _new_shape_gradients("cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.isfinite(a[k]).all() and float(cpu[k].norm()) > 0, k
        assert float((a[k] - cpu[k]).norm() / cpu[k].norm()) <= 1e-3, k


# ------------------------- repeatable splats, scene files, the command line

def test_splat_and_guiding_repeat_on_card():
    """``splat`` and the guiding grid's update on the card (the fixed-point
    scatter of ``index_add_rows``): two runs bit for bit, in a crowded
    corner of signed values too; each pixel within 1e-6 of the float64
    splat of positive values; the gradient with respect to the values
    the gather of the pixels' gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba_tpu_torch.models.film import ReconstructionFilter, splat
    from mitsuba_tpu_torch.models.integrators.guiding import GridDistr

    g = torch.Generator().manual_seed(6)
    n, h, w = 300_000, 64, 64
    rf = ReconstructionFilter.gaussian()
    crowd = torch.rand(n, 2, generator=g) * 8.0 + 20.0
    signed = torch.randn(n, 3, generator=g)
    a, b = (splat(crowd.cuda(), signed.cuda(), h, w, rf) for _ in range(2))
    assert torch.equal(a, b)
    pos = torch.rand(n, 2, generator=g) * torch.tensor([w, h])
    val = torch.rand(n, 3, generator=g) + 0.1
    got = splat(pos.cuda(), val.cuda(), h, w, rf).cpu()
    want = splat(pos.double(), val.double(), h, w, rf).float()
    assert torch.allclose(got, want, rtol=1e-6, atol=0.0)
    leaf = val.cuda().requires_grad_()
    weight = torch.rand(h, w, 4, generator=g).cuda()
    torch.sum(splat(pos.cuda(), leaf, h, w, rf) * weight).backward()
    cpu_leaf = val.clone().requires_grad_()
    torch.sum(splat(pos, cpu_leaf, h, w, rf) * weight.cpu()).backward()
    assert torch.allclose(leaf.grad.cpu(), cpu_leaf.grad, rtol=1e-5,
                          atol=1e-6)
    idx = torch.randint(0, 500, (n,), generator=g)
    mass = torch.rand(n, generator=g)
    grids = [GridDistr.create(torch.ones(500, device=d)).update(
        idx.to(d), mass.to(d)).mass.cpu() for d in ("cuda", "cuda", "cpu")]
    assert torch.equal(grids[0], grids[1])
    assert torch.allclose(grids[0], grids[2], rtol=1e-5, atol=0.0)


_CLI_XML = """
<scene version="3.0.0">
  <default name="spp" value="8"/>
  <integrator type="path"><integer name="max_depth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="0, 0, 3.9" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sample_count" value="$spp"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="64"/>
      <integer name="height" value="48"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white">
    <rgb name="reflectance" value="0.8, 0.7, 0.6"/>
  </bsdf>
  <shape type="rectangle" id="light">
    <transform name="to_world">
      <scale value="0.25"/>
      <rotate x="1" angle="90"/>
      <translate y="0.99"/>
    </transform>
    <ref id="white"/>
    <emitter type="area"><rgb name="radiance" value="15, 12, 8"/></emitter>
  </shape>
  <shape type="cube" id="box">
    <transform name="to_world"><scale value="0.4"/></transform>
    <ref id="white"/>
  </shape>
  <emitter type="point">
    <point name="position" x="0.5" y="0.5" z="1"/>
    <rgb name="intensity" value="2, 2, 2"/>
  </emitter>
</scene>
"""


def test_cli_on_card(tmp_path):
    """``python -m mitsuba_tpu_torch`` on the card writes the EXR of
    ``render(load_file(...))`` in this process, bit for bit, and
    ``intersect_packed`` renders the loaded box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys

    from mitsuba_tpu_torch import load_file, render
    from mitsuba_tpu_torch.utils.bitmap import read_image

    path = tmp_path / "scene.xml"
    path.write_text(_CLI_XML)
    out = tmp_path / "out.exr"
    proc = subprocess.run(
        [sys.executable, "-m", "mitsuba_tpu_torch", str(path), "-o", str(out),
         "-D", "spp=4"], capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "rendered in" in proc.stdout
    before = intersect_packed.launches
    want = render(load_file(str(path), spp=4), seed=0).cpu().numpy()
    assert intersect_packed.launches > before
    assert np.array_equal(read_image(out), want)
