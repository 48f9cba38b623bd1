"""The port's megakernel path against mitsuba_tpu's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_megakernel.py does; the port's wrapper takes its plain
PyTorch version for CPU tensors.  Both draw the same (seed, lane, dim)
stream, so per-lane radiance agrees to float rounding except on the rare
lane where rounding flips a russian-roulette or visibility decision
(hence the thresholds of tests/test_megakernel.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
from mitsuba_tpu.models.bsdfs import NullBSDF
from mitsuba_tpu.models.integrators import MegakernelPathIntegrator as JMegapath
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.ops.pallas.megakernel import megakernel_trace as jtrace
from mitsuba_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                               cornell_box, render, sample_rays,
                               scene_from_numpy)
from mitsuba_tpu_torch.models.emitters import AreaEmitter
from mitsuba_tpu_torch.models.scene import make_scene
from mitsuba_tpu_torch.models.shapes import Mesh
from mitsuba_tpu_torch.models.textures import ConstantTexture
from mitsuba_tpu_torch.ops.megakernel import (megakernel_trace,
                                              megakernel_trace_plain,
                                              pack_scene)
from torch_parity import export_scene


def test_plain_matches_jax_per_lane():
    seed, spp, depth = 3, 2, 6
    jscene = jcornell_box(width=16, height=16)
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(seed), spp)
    active = np.ones(lane.shape, bool)
    jtris, jlight, F, L, _, _ = jpack_scene(jscene)
    want = np.asarray(jtrace(
        jtris, jlight, lane, ray.o, ray.d, jnp.asarray(active),
        jnp.uint32(seed), max_depth=depth, rr_depth=5, n_faces=F,
        n_lights=L, interpret=True))

    tris, light, tF, tL, _, _ = pack_scene(
        scene_from_numpy(export_scene(jscene), device="cpu"))
    before = megakernel_trace.launches
    got = megakernel_trace(
        tris, light, torch.tensor(np.asarray(lane)),
        torch.tensor(np.asarray(ray.o)), torch.tensor(np.asarray(ray.d)),
        torch.tensor(active), seed, max_depth=depth, rr_depth=5,
        n_faces=tF, n_lights=tL).numpy()
    assert megakernel_trace.launches == before   # the CPU runs no kernel
    assert got.shape == want.shape == (16 * 16 * spp, 3)
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} lanes match"
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def test_render_matches_jax():
    want = np.asarray(mitsuba_tpu.render(
        jcornell_box(width=16, height=16), JMegapath(max_depth=6),
        seed=0, spp=4))
    got = render(cornell_box(16, 16, device="cpu"),
                 MegakernelPathIntegrator(max_depth=6, rr_depth=5),
                 seed=0, spp=4, device="cpu").numpy()
    assert got.shape == want.shape == (16, 16, 3)
    rel = np.abs(got - want).mean() / want.mean()
    assert rel < 5e-3, f"rel err {rel}"


def test_multipass_render_matches_single_pass():
    scene = cornell_box(8, 8, device="cpu")
    integ = MegakernelPathIntegrator(max_depth=4, rr_depth=2)
    one = render(scene, integ, seed=1, spp=4, device="cpu")
    two = render(scene, integ, seed=1, spp=4, device="cpu", spp_per_pass=2)
    torch.testing.assert_close(two, one, rtol=1e-5, atol=1e-6)


def test_plain_counts_work():
    """counts= reports the ray-triangle tests the kernel does: every face
    for each lane alive at a bounce; shadow rays stop at their occluder."""
    scene = cornell_box(4, 4, device="cpu")
    ray, _, _, lane = sample_rays(scene, 0, 1)
    tris, light, F, L, _, _ = pack_scene(scene)
    counts = {}
    megakernel_trace_plain(tris, light, lane, ray.o, ray.d,
                           torch.ones(16, dtype=torch.bool), 0, max_depth=1,
                           rr_depth=5, n_faces=F, n_lights=L, counts=counts)
    assert counts == {"closest_tests": 16 * F, "shadow_tests": 0}


def test_conductor_box_raises():
    """A BSDF that is still unported (here the small box made a null BSDF;
    conductors and plastics are ported now) raises at the conversion."""
    base = jcornell_box(width=8, height=8)
    meshes = list(base.meshes)
    meshes[6] = meshes[6].replace(bsdf_index=3)   # small box -> null
    jscene = jmake_scene(
        meshes, list(base.bsdfs) + [NullBSDF()],
        list(base.emitters), base.sensor, use_bvh=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scene_from_numpy(export_scene(jscene), device="cpu")


def test_scene_outside_subset_raises():
    """A scene outside the plugin subset raises with ``strict=True`` and
    otherwise falls back to the wavefront PathIntegrator: here the second
    light of a clutter mesh that also takes the scene over 1024 faces."""
    base = cornell_box(4, 4, device="cpu")
    r = np.random.default_rng(0)
    big = Mesh.make(r.random((3000, 3)), np.arange(3000).reshape(1000, 3),
                    bsdf_index=0, emitter_index=1, id="clutter", device="cpu")
    glow = AreaEmitter(radiance=ConstantTexture(torch.ones(3)))
    scene = make_scene(list(base.meshes) + [big], base.bsdfs,
                       list(base.emitters) + [glow], base.sensor, "cpu")
    with pytest.raises(ValueError, match="outside"):
        render(scene, MegakernelPathIntegrator(strict=True), spp=1,
               device="cpu")
    image = render(scene, MegakernelPathIntegrator(), spp=1, device="cpu")
    assert torch.isfinite(image).all() and image.mean() > 0
    torch.testing.assert_close(image, render(scene, PathIntegrator(), spp=1,
                                             device="cpu"), rtol=0, atol=0)


@pytest.mark.parametrize("variant", [
    {"btypes": (0, 24)}, {"env_meta": torch.zeros(1, 32)},
    {"btypes": (0, 21)}, {"env_pos": 0}])
def test_wrapper_rejects_unported_variants(variant):
    scene = cornell_box(2, 2, device="cpu")
    tris, light, F, L, _, _ = pack_scene(scene)
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        megakernel_trace(tris, light, torch.zeros(4, dtype=torch.int32), o, o,
                         torch.ones(4, dtype=torch.bool), 0, max_depth=2,
                         rr_depth=5, n_faces=F, n_lights=L, **variant)


def test_entry_points_need_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cornell_box(4, 4)
