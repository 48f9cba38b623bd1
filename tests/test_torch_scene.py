"""The port's scene, primary rays and film against mitsuba_tpu on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.models import film as jfilm
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
from mitsuba_tpu_torch import cornell_box, sample_rays, scene_from_numpy
from mitsuba_tpu_torch.models import film as tfilm
from mitsuba_tpu_torch.ops.megakernel import megakernel_applicable, pack_scene
from torch_parity import export_scene


@pytest.fixture(scope="module")
def jscene():
    return jcornell_box(width=8, height=8)


@pytest.mark.parametrize("build", ["cornell_box", "scene_from_numpy"])
def test_pack_scene_matches(jscene, build):
    if build == "cornell_box":
        scene = cornell_box(8, 8, device="cpu")
    else:
        scene = scene_from_numpy(export_scene(jscene), device="cpu")
    assert megakernel_applicable(scene)
    jtris, jlight, jF, jL, _, _ = jpack_scene(jscene)
    tris, light, F, L, _, _ = pack_scene(scene)
    assert (F, L) == (jF, jL) == (36, 2)
    np.testing.assert_allclose(tris.numpy(), np.asarray(jtris)[:F], atol=1e-6)
    np.testing.assert_allclose(light.numpy(), np.asarray(jlight)[:L],
                               atol=1e-6)


def test_sample_rays_matches(jscene):
    seed, spp = 3, 2
    ray, weight, film_pos, lane = jsample_rays(jscene, jnp.uint32(seed), spp)
    tray, tweight, tfilm_pos, tlane = sample_rays(
        cornell_box(8, 8, device="cpu"), seed, spp)
    assert tlane.dtype == torch.int32
    np.testing.assert_array_equal(tlane.numpy(), np.asarray(lane))
    for got, want in [(tray.o, ray.o), (tray.d, ray.d), (tweight, weight),
                      (tfilm_pos, film_pos)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_sample_rays_multipass_lanes():
    """A later pass continues each pixel's lanes: pixel * spp + sample."""
    scene = cornell_box(4, 4, device="cpu")
    _, _, _, lane = sample_rays(scene, 0, spp=4, spp_pass=2, pass_index=1)
    want = (np.arange(16)[:, None] * 4 + 2 + np.arange(2)[None, :]).ravel()
    np.testing.assert_array_equal(lane.numpy(), want)


@pytest.mark.parametrize("kind", ["gaussian", "box"])
def test_splat_grouped_develop_matches(kind):
    h, w, spp = 5, 6, 3
    r = np.random.default_rng(5)
    n = h * w * spp
    pix = np.repeat(np.arange(h * w), spp)
    pos = (np.stack([pix % w, pix // w], -1) + r.random((n, 2))).astype(np.float32)
    values = r.random((n, 3)).astype(np.float32)
    active = r.random(n) > 0.1
    jf = getattr(jfilm.ReconstructionFilter, kind)()
    tf = getattr(tfilm.ReconstructionFilter, kind)()
    want = jfilm.develop(jfilm.splat_grouped(
        jnp.asarray(pos), jnp.asarray(values), h, w, spp, jf,
        jnp.asarray(active)))
    got = tfilm.Film(width=w, height=h, rfilter=tf).put_grouped(
        torch.as_tensor(pos), torch.as_tensor(values), spp,
        torch.as_tensor(active))
    np.testing.assert_allclose(tfilm.develop(got).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_splat_grouped_rejects_unsorted_lanes():
    film = tfilm.Film(width=4, height=4)
    with pytest.raises(ValueError):
        film.put_grouped(torch.zeros(10, 2), torch.zeros(10, 3), spp=1)
