"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one.  They
import only the port, so they run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Per-lane bar of tests/test_megakernel.py: rounding may flip a rare
russian-roulette or visibility decision, nothing more.
"""
import dataclasses

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
from mitsuba_tpu_torch.ops.traverse import (packet_any_hit,
                                            packet_any_hit_plain,
                                            packet_closest_hit,
                                            packet_closest_hit_plain)

from torch_parity import nested_clusters

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
    tris, light, n_faces, n_lights = pack_scene(scene)
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
    tris, light, n_faces, n_lights = pack_scene(scene)
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
                              btypes=(0, 6))


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
    tris, light, n_faces, n_lights = pack_scene(scene)
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
    tris, light, n_faces, n_lights = pack_scene(scene)
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
    for both kernels and both builds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for kernel in ("trace", "bounce"):
        for btypes in ((0,), (0, 1, 2, 3, 4)):
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
