"""The port's wavefront PathIntegrator and its brute hit query against
mitsuba_tpu, on the CPU.

- ``intersect_packed``: the port's plain version against the JAX Pallas
  kernel in interpret mode, prim for prim, including its block tie rule.
- ``PathIntegrator``: per lane against the JAX ``PathIntegrator``, which
  on the CPU sweeps the faces with ``intersect_brute``.  The (seed, lane,
  dim) stream is the same, so lanes agree to float rounding except where
  rounding or a hit tie flips a rare russian-roulette or visibility
  decision (the bar of tests/test_megakernel.py).
- ``MegakernelPathIntegrator`` on a scene outside its subset falls back
  to the ``PathIntegrator``, as the JAX package's does.
"""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.models.emitters import AreaEmitter as JAreaEmitter
from mitsuba_tpu.models.integrators import MegakernelPathIntegrator as JMegapath
from mitsuba_tpu.models.integrators import PathIntegrator as JPath
from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.models.textures import ConstantTexture as JConstantTexture
from mitsuba_tpu.ops.pallas.intersect_pallas import \
    intersect_packed as jintersect_packed
from mitsuba_tpu.ops.pallas.intersect_pallas import \
    pack_triangles as jpack_triangles
from mitsuba_tpu.utils.scenes import cornell_box as jcornell_box
from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                               cornell_box, render, sample_rays,
                               scene_from_numpy)
from mitsuba_tpu_torch.ops.intersect_packed import (intersect_packed,
                                                    intersect_packed_plain,
                                                    pack_triangles)
from torch_parity import export_scene

SEED, SPP = 5, 2


def _assert_lanes_close(got, want):
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} lanes match"
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def _jax_lanes(jscene, integrator):
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(SEED), SPP)
    return np.asarray(integrator.sample(jscene, ray, lane, jnp.uint32(SEED),
                                        jnp.ones(lane.shape, bool)))


def _port_lanes(scene, integrator):
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    return integrator.sample(scene, ray, lane, SEED,
                             torch.ones(lane.shape, dtype=torch.bool)).numpy()


def _run_both(tris_j, tris_t, o, d, maxt):
    want = [np.asarray(x) for x in jintersect_packed(
        tris_j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt),
        interpret=True)]
    before = intersect_packed.launches
    got = [x.numpy() for x in intersect_packed(
        tris_t, torch.tensor(o), torch.tensor(d), torch.tensor(maxt),
        torch.ones(len(o), dtype=torch.bool))]
    assert intersect_packed.launches == before   # the CPU runs no kernel
    return got, want


@pytest.mark.parametrize("finite_maxt", [True, False])
def test_intersect_packed_plain_matches_pallas(finite_maxt):
    """1,024 seeded rays from inside the Cornell box against its packed
    table: prim for prim, t, u, v within 1e-6."""
    jscene = jcornell_box(width=4, height=4)
    v, f = (np.asarray(x) for x in jscene.geometry()[:2])
    tris_j = jpack_triangles(jnp.asarray(v), jnp.asarray(f))
    tris_t = pack_triangles(torch.tensor(v), torch.tensor(f).long())
    # JAX pads the table to 128 columns for the TPU's lanes; the port does not
    np.testing.assert_array_equal(tris_t.numpy(),
                                  np.asarray(tris_j)[:, :len(f)])
    r = np.random.default_rng(11)
    n = 1024
    o = r.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = (r.uniform(0.2, 2.5, n) if finite_maxt
            else np.full(n, np.inf)).astype(np.float32)
    (t, prim, u, vv), (jt, jprim, ju, jv) = _run_both(tris_j, tris_t, o, d,
                                                      maxt)
    hit = np.isfinite(jt)
    assert 0.3 < hit.mean() <= 1.0
    np.testing.assert_array_equal(prim, jprim)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    for got, want in ((t, jt), (u, ju), (vv, jv)):
        np.testing.assert_allclose(got[hit], want[hit], rtol=1e-6, atol=1e-6)


def test_intersect_packed_block_tie_rule():
    """Faces 10, 20 and 140 of a 300-face table coincide: the largest
    index wins within the first 128-face block, and face 140's equal t
    does not displace it from a later block.  Both give 20."""
    r = np.random.default_rng(3)
    v = (r.uniform(-1, 1, (900, 3)) + [0, 0, 50]).astype(np.float32)
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    for j in (10, 20, 140):
        v[3 * j:3 * j + 3] = tri
    f = np.arange(900).reshape(300, 3)
    o = np.array([[0.0, 0.0, -1.0], [0.2, -0.3, -2.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    maxt = np.full(2, np.inf, np.float32)
    got, want = _run_both(jpack_triangles(jnp.asarray(v), jnp.asarray(f)),
                          pack_triangles(torch.tensor(v), torch.tensor(f)),
                          o, d, maxt)
    np.testing.assert_array_equal(want[1], [20, 20])
    np.testing.assert_array_equal(got[1], [20, 20])
    np.testing.assert_array_equal(got[0], want[0])


def test_intersect_packed_active_and_counts():
    scene = cornell_box(4, 4, device="cpu")
    ray, _, _, _ = sample_rays(scene, 0, 1)
    v, f = scene.geometry()[:2]
    tris = pack_triangles(v, f)
    active = torch.arange(16) % 3 != 0
    counts = {}
    t, prim, u, vv = intersect_packed_plain(tris, ray.o, ray.d, ray.maxt,
                                            active, counts=counts)
    assert counts == {"tests": int(active.sum()) * 36}
    assert torch.isinf(t[~active]).all() and (prim[~active] == -1).all()
    assert not u[~active].any() and not vv[~active].any()
    assert torch.isfinite(t[active]).float().mean() > 0.5
    full = intersect_packed(tris, ray.o, ray.d, ray.maxt,
                            torch.ones(16, dtype=torch.bool))
    for a, b in zip((t, prim, u, vv), full):
        torch.testing.assert_close(a[active], b[active], rtol=0, atol=0)


def test_path_matches_jax_cornell():
    """16x16 x 2 spp, depth 6, rr 5, seed 5: the port's sweep over the
    36 faces against JAX's intersect_brute."""
    jscene = jcornell_box(width=16, height=16)
    want = _jax_lanes(jscene, JPath(max_depth=6, rr_depth=5))
    got = _port_lanes(scene_from_numpy(export_scene(jscene), device="cpu"),
                      PathIntegrator(max_depth=6, rr_depth=5))
    _assert_lanes_close(got, want)


def _jax_two_lights():
    """The JAX Cornell box whose floor glows too: two area lights, outside
    both packages' megakernel subset."""
    base = jcornell_box(width=16, height=16)
    meshes = list(base.meshes)
    meshes[1] = meshes[1].replace(emitter_index=1)
    glow = JAreaEmitter(radiance=JConstantTexture(
        jnp.asarray([0.5, 0.4, 0.3])), sampling_weight=0.5)
    return jmake_scene(meshes, list(base.bsdfs), list(base.emitters) + [glow],
                       base.sensor, use_bvh=False)


def test_megapath_falls_back_on_two_lights(caplog):
    """The JAX MegakernelPathIntegrator falls back to its PathIntegrator
    here, and so does the port's, per lane; the second light's sampling
    weight of 0.5 rides the conversion."""
    jscene = _jax_two_lights()
    want = _jax_lanes(jscene, JMegapath(max_depth=6, rr_depth=5))
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    assert [e.sampling_weight for e in scene.emitters] == [1.0, 0.5]
    with caplog.at_level(logging.INFO, "mitsuba_tpu_torch"):
        got = _port_lanes(scene, MegakernelPathIntegrator(6, 5))
    assert "falling back to the wavefront PathIntegrator" in caplog.text
    _assert_lanes_close(got, want)
    with pytest.raises(ValueError, match="outside"):
        _port_lanes(scene, MegakernelPathIntegrator(6, 5, strict=True))


def test_render_path_integrator():
    """The public entry point with the wavefront integrator; the
    unported options raise."""
    image = render(cornell_box(8, 8, device="cpu"),
                   PathIntegrator(max_depth=4, rr_depth=3, hide_emitters=True),
                   seed=1, spp=2, device="cpu")
    assert image.shape == (8, 8, 3) and torch.isfinite(image).all()
    assert image.mean() > 0
    for kw in ({"ray_diffs": True}, {"timeout": 1.0}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PathIntegrator(**kw)
    scene = cornell_box(2, 2, device="cpu")
    ray, _, _, lane = sample_rays(scene, 0, 1)
    scene.sensor = dataclasses.replace(scene.sensor, sampler=object())
    with pytest.raises(NotImplementedError, match="sampler"):
        PathIntegrator().sample(scene, ray, lane, 0,
                                torch.ones(4, dtype=torch.bool))
