"""The port's BVH megakernel path and smooth shading against mitsuba_tpu,
on the CPU.

The reference is the JAX wavefront ``PathIntegrator``: on a scene built
with ``use_bvh=True`` it walks ``ops/bvh.intersect_bvh`` on the CPU and
never touches the packet kernels (ROADMAP, Queue 3).  It draws the same
(seed, lane, dim) stream as the megakernels, so per-lane radiance agrees
to float rounding except on the rare lane where rounding flips a
russian-roulette or visibility decision (the bar of
tests/test_megakernel.py).  The port's wrappers take their plain PyTorch
versions for CPU tensors.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.models.integrators import PathIntegrator as JPath
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                               big_scene, render, sample_rays,
                               scene_from_numpy)
from mitsuba_tpu_torch.models.bsdfs import SmoothConductor
from mitsuba_tpu_torch.models.emitters import AreaEmitter
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.textures import ConstantTexture
from mitsuba_tpu_torch.ops import megakernel_bvh as mkb
from torch_parity import export_scene, jax_scene_with_ball

SEED, SPP = 5, 2


def _jax_and_port(subdiv, use_bvh):
    """Per-lane L of the JAX PathIntegrator (16x16 x 2 spp, depth 6, rr 5)
    and the port's scene built from the same arrays."""
    jscene = jax_scene_with_ball(16, 16, subdiv, use_bvh=use_bvh)
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    want = np.asarray(JPath(max_depth=6, rr_depth=5).sample(
        jscene, ray, lane, jnp.uint32(SEED), jnp.ones(lane.shape, bool)))
    return want, scene_from_numpy(export_scene(jscene), device="cpu")


@pytest.fixture(scope="module")
def bvh_case():
    """Cornell box + sphere_mesh(3): 1,316 faces, so the port walks a BVH."""
    want, scene = _jax_and_port(3, use_bvh=True)
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    active = torch.ones(lane.shape, dtype=torch.bool)
    return want, scene, ray, lane, active


def _assert_lanes_close(got, want):
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} lanes match"
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def test_bvh_path_matches_jax_wavefront(bvh_case):
    want, scene, ray, lane, active = bvh_case
    assert scene.accel is not None and mkb.megakernel_bvh_applicable(scene)
    before = mkb.megakernel_bounce_bvh.launches
    got = MegakernelPathIntegrator(max_depth=6, rr_depth=5).sample(
        scene, ray, lane, SEED, active)
    assert mkb.megakernel_bounce_bvh.launches == before   # no kernel on CPU
    _assert_lanes_close(got.numpy(), want)


def test_path_integrator_matches_jax_wavefront(bvh_case):
    """The port's wavefront PathIntegrator, whose BVH queries are
    ``packet_closest_hit``/``packet_any_hit``, against the same JAX
    reference: no BVH megakernel runs."""
    want, scene, ray, lane, active = bvh_case
    before = mkb.megakernel_bounce_bvh.launches, mkb.megakernel_trace_bvh.launches
    got = PathIntegrator(max_depth=6, rr_depth=5).sample(scene, ray, lane,
                                                         SEED, active)
    assert (mkb.megakernel_bounce_bvh.launches,
            mkb.megakernel_trace_bvh.launches) == before
    _assert_lanes_close(got.numpy(), want)


def test_sort_bounces_and_single_launch_agree(bvh_case):
    """Lanes ride every permutation: the per-depth sorted pipeline, the
    single-launch form and its plain version give the same L per lane."""
    _, scene, ray, lane, active = bvh_case
    on = MegakernelPathIntegrator(6, 5).sample(scene, ray, lane, SEED, active)
    off = MegakernelPathIntegrator(6, 5, sort_bounces=False).sample(
        scene, ray, lane, SEED, active)
    every2 = MegakernelPathIntegrator(6, 5, sort_every=2).sample(
        scene, ray, lane, SEED, active)
    plain = mkb.megakernel_trace_bvh_plain(
        mkb.pack_scene_bvh(scene), lane, ray.o, ray.d, active, SEED, 6, 5,
        smooth=True)
    for other in (off, every2, plain):
        torch.testing.assert_close(other, on, rtol=0, atol=0)


def test_bounce_plain_counts_and_state(bvh_case):
    """One bounce from the primary state: the plain version reports the
    work of the walk, leaves its input alone, and the wrapper updates the
    state in place to the same values."""
    _, scene, ray, lane, active = bvh_case
    tables = mkb.pack_scene_bvh(scene)
    state = mkb.primary_state(ray.o, ray.d, active)
    before = state.clone()
    counts = {}
    new = mkb.megakernel_bounce_bvh_plain(tables, lane, SEED, state, 0, 6, 5,
                                          smooth=True, counts=counts)
    torch.testing.assert_close(state, before, rtol=0, atol=0)
    assert counts["node_visits"] >= lane.shape[0]   # every lane tests the root
    assert 0 < counts["shadow_tests"] < counts["closest_tests"]
    out = mkb.megakernel_bounce_bvh(tables, lane, SEED, state, 0, 6, 5,
                                    smooth=True)
    assert out is state
    torch.testing.assert_close(state, new, rtol=0, atol=0, equal_nan=True)


def test_pack_scene_bvh_tables(bvh_case):
    _, scene, _, _, _ = bvh_case
    t = mkb.pack_scene_bvh(scene)
    acc = scene.accel
    m = acc.n_nodes
    assert t.node_box.shape == (m, 8) and t.node_meta.shape == (m, 4)
    torch.testing.assert_close(t.node_box[:, 0:3], acc.bbox_lo)
    torch.testing.assert_close(t.node_box[:, 4:7], acc.bbox_hi)
    assert torch.equal(t.node_meta[:, 2], acc.miss)
    face = t.leaf_face.long()
    real = face >= 0
    assert int(real.sum()) == t.n_faces == 1316
    torch.testing.assert_close(t.leaf_geo[real, :9], t.tris[face[real], :9])
    assert not t.leaf_geo[~real].any() and not t.leaf_geo[:, 9:].any()


def test_brute_smooth_matches_jax_wavefront():
    """Cornell box + sphere_mesh(2): 356 faces with smooth normals take
    the brute kernel, whose smooth gate is open now."""
    want, scene = _jax_and_port(2, use_bvh=None)
    assert scene.accel is None
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    got = MegakernelPathIntegrator(max_depth=6, rr_depth=5).sample(
        scene, ray, lane, SEED, torch.ones(lane.shape, dtype=torch.bool))
    _assert_lanes_close(got.numpy(), want)


def test_render_big_scene():
    image = render(big_scene(8, 8, subdiv=3, device="cpu"),
                   MegakernelPathIntegrator(max_depth=4, rr_depth=3),
                   seed=1, spp=2, device="cpu")
    assert image.shape == (8, 8, 3) and torch.isfinite(image).all()
    assert image.mean() > 0


def test_bvh_scene_outside_subset_raises():
    """Two lights on a BVH scene: ``strict=True`` raises, the default
    falls back to the wavefront PathIntegrator and its BVH queries."""
    base = big_scene(4, 4, subdiv=3, device="cpu")
    meshes = list(base.meshes)
    # the floor glows too: two lights
    meshes[1] = dataclasses.replace(meshes[1], emitter_index=1)
    glow = AreaEmitter(radiance=ConstantTexture(torch.ones(3)))
    scene = make_scene(meshes, base.bsdfs, list(base.emitters) + [glow],
                       base.sensor, "cpu")
    assert scene.accel is not None
    with pytest.raises(ValueError, match="outside"):
        render(scene, MegakernelPathIntegrator(strict=True), spp=1,
               device="cpu")
    image = render(scene, MegakernelPathIntegrator(), spp=1, device="cpu")
    assert torch.isfinite(image).all() and image.mean() > 0
    torch.testing.assert_close(image, render(scene, PathIntegrator(), spp=1,
                                             device="cpu"), rtol=0, atol=0)


@pytest.mark.parametrize("variant", [
    {"btypes": (0, 6)}, {"tex": torch.zeros(1, 128)}, {"env_pos": 0},
    {"env_nee_d": torch.zeros(4, 8)}])
def test_bounce_rejects_unported_variants(bvh_case, variant):
    _, scene, _, _, _ = bvh_case
    with pytest.raises(ValueError):
        mkb.megakernel_bounce_bvh(mkb.pack_scene_bvh(scene),
                                  torch.zeros(4, dtype=torch.int32), 0,
                                  torch.zeros(16, 4), 0, 6, 5, **variant)


def test_trace_bvh_rejects_unported_variants(bvh_case):
    _, scene, _, _, _ = bvh_case
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        mkb.megakernel_trace_bvh(mkb.pack_scene_bvh(scene),
                                 torch.zeros(4, dtype=torch.int32), o, o,
                                 torch.ones(4, dtype=torch.bool), 0, 6, 5,
                                 btypes=(0, 6))


@dataclasses.dataclass
class SmoothPlastic:
    """Stands for the JAX package's plastic BSDF, which the port has not
    ported yet (code 6)."""

    diffuse_reflectance: object
    eta: torch.Tensor


def test_diffuse_only():
    """A BSDF outside the ported lobes (plastic) keeps the scene out of
    the subset; a conductor does not."""
    base = big_scene(4, 4, subdiv=3, device="cpu")
    assert mkb.megakernel_bvh_applicable(base)
    for bsdf, inside in (
            (SmoothPlastic(diffuse_reflectance=base.bsdfs[0].reflectance,
                           eta=torch.tensor(1.5)), False),
            (SmoothConductor(eta=torch.ones(3), k=torch.ones(3)), True)):
        bsdfs = list(base.bsdfs)
        bsdfs[0] = bsdf
        scene = make_scene(base.meshes, bsdfs, base.emitters, base.sensor,
                           "cpu")
        assert mkb.megakernel_bvh_applicable(scene) == inside
