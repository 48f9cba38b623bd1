"""The port's point, spot, projector, constant and directional emitters,
and the environment map's particles, against mitsuba_tpu on the CPU.

Each emitter is built with the same parameters in both packages, and each
method (``eval``, ``eval_env`` where the emitter is infinite,
``sample_direction``, ``pdf_direction``, ``eval_direction`` and
``sample_ray``) runs on the same seeded numpy inputs; every output is
held within 1e-6 of the JAX package's, relative to its largest entry.
The infinite emitters get the scene's bounding sphere as ``make_scene``
gives it.  Of the environment map, only ``sample_ray`` is new; its other
methods are held by tests/test_torch_envmap.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.records import DirectionSample as JDirectionSample
from mitsuba_tpu.models import emitters as jem
from mitsuba_tpu.models.textures import BitmapTexture as JBitmap
from mitsuba_tpu_torch.core.distr2d import Marginal2D
from mitsuba_tpu_torch.core.records import DirectionSample
from mitsuba_tpu_torch.models import emitters as em
from mitsuba_tpu_torch.models.textures import BitmapTexture

N = 4096
CENTER = np.asarray([0.1, -0.2, 0.3], np.float32)
RADIUS = np.float32(2.5)
KINDS = ("point", "spot", "projector", "constant", "directional")
INFINITE = ("constant", "directional")


def _rng(k=0):
    return np.random.default_rng(100 + k)


def _params():
    r = _rng()
    f32 = np.float32
    return {
        "intensity": r.uniform(0.5, 4.0, 3).astype(f32),
        "position": r.uniform(-0.5, 0.5, 3).astype(f32),
        "direction": r.normal(size=3).astype(f32),
        "up": np.asarray([0.1, 1.0, 0.2], f32),
        "texels": r.uniform(0.0, 2.0, (12, 16, 3)).astype(f32),
        "env": r.uniform(0.0, 3.0, (16, 32, 3)).astype(f32),
    }


def _both(kind):
    """(JAX emitter, port emitter) of ``kind``."""
    p = _params()
    t = {k: torch.tensor(v) for k, v in p.items()}
    j = {k: jnp.asarray(v) for k, v in p.items()}
    bounds = dict(scene_center=jnp.asarray(CENTER),
                  scene_radius=jnp.asarray(RADIUS))
    port_bounds = dict(scene_center=tuple(float(c) for c in CENTER),
                       scene_radius=float(RADIUS))
    if kind == "point":
        return (jem.PointEmitter(intensity=j["intensity"],
                                 position=j["position"]),
                em.PointEmitter(intensity=t["intensity"],
                                position=t["position"]))
    if kind == "spot":
        kw = dict(cutoff_angle=35.0, beam_width=20.0)
        return (jem.SpotEmitter(intensity=j["intensity"],
                                position=j["position"],
                                direction=j["direction"], **kw),
                em.SpotEmitter(intensity=t["intensity"],
                               position=t["position"],
                               direction=t["direction"], **kw))
    if kind == "projector":
        return (jem.ProjectorEmitter(
                    irradiance=JBitmap(data=j["texels"]),
                    position=j["position"], direction=j["direction"],
                    up=j["up"], scale=jnp.asarray(1.5), fov=60.0),
                em.ProjectorEmitter(
                    irradiance=BitmapTexture(data=t["texels"]),
                    position=t["position"], direction=t["direction"],
                    up=t["up"], scale=torch.tensor(1.5), fov=60.0))
    if kind == "constant":
        return (jem.ConstantEmitter(radiance=j["intensity"], **bounds),
                em.ConstantEmitter(radiance=t["intensity"], **port_bounds))
    if kind == "directional":
        return (jem.DirectionalEmitter(irradiance=j["intensity"],
                                       direction=j["direction"], **bounds),
                em.DirectionalEmitter(irradiance=t["intensity"],
                                      direction=t["direction"],
                                      **port_bounds))
    je = jem.EnvmapEmitter.create(p["env"]).replace(**bounds)
    pe = em.EnvmapEmitter.create(p["env"], device="cpu", distr=Marginal2D(**{
        k: torch.tensor(np.asarray(getattr(je.distr, k))) for k in (
            "pdf_table", "row_cdf", "cond_cdf", "row_weight", "total")}))
    return je, dataclasses.replace(pe, **port_bounds)


def _inputs():
    r = _rng(1)
    ref_p = r.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    u1 = r.uniform(size=N).astype(np.float32)
    u2 = r.uniform(size=(N, 2)).astype(np.float32)
    u3 = r.uniform(size=(N, 2)).astype(np.float32)
    active = r.uniform(size=N) > 0.2
    d = r.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ref_p, u1, u2, u3, active, d


def _close(got, want, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= 1e-6, f"{what}: {err:.3e} relative"


def _port_ds(jds):
    return DirectionSample(**{k: torch.tensor(np.asarray(getattr(jds, k)))
                              for k in ("p", "n", "uv", "d", "dist", "pdf",
                                        "delta")},
                           emitter_index=torch.zeros(N, dtype=torch.int64))


class _SI:
    def __init__(self, uv):
        self.uv = uv


@pytest.mark.parametrize("kind", KINDS)
def test_eval_matches_jax(kind):
    """``eval`` at surface points (0 but for the JAX constant light,
    which returns its radiance) and, on the infinite emitters,
    ``eval_env`` along escaped directions."""
    jemit, pemit = _both(kind)
    _, _, u2, _, active, d = _inputs()
    _close(pemit.eval(_SI(torch.tensor(u2)), torch.tensor(active)),
           jemit.eval(_SI(jnp.asarray(u2)), jnp.asarray(active)),
           f"{kind} eval")
    if kind in INFINITE:
        _close(pemit.eval_env(torch.tensor(d), torch.tensor(active)),
               jemit.eval_env(jnp.asarray(d), jnp.asarray(active)),
               f"{kind} eval_env")


@pytest.mark.parametrize("kind", KINDS)
def test_sample_direction_matches_jax(kind):
    """The NEE sample's record and weight, then ``pdf_direction`` and
    ``eval_direction`` (under a mask) of the JAX package's record."""
    jemit, pemit = _both(kind)
    ref_p, u1, u2, _, active, _ = _inputs()
    jds, jw = jemit.sample_direction(jnp.asarray(ref_p), jnp.asarray(u1),
                                     jnp.asarray(u2), None)
    pds, pw = pemit.sample_direction(torch.tensor(ref_p), torch.tensor(u1),
                                     torch.tensor(u2), None)
    for k in ("p", "n", "d", "dist", "pdf"):
        _close(getattr(pds, k), getattr(jds, k), f"{kind} ds.{k}")
    assert np.array_equal(pds.delta.numpy(), np.asarray(jds.delta))
    _close(pw, jw, f"{kind} weight")
    ds = _port_ds(jds)
    _close(pemit.pdf_direction(torch.tensor(ref_p), ds, None),
           jemit.pdf_direction(jnp.asarray(ref_p), jds, None),
           f"{kind} pdf_direction")
    _close(pemit.eval_direction(torch.tensor(ref_p), ds, None,
                                torch.tensor(active)),
           jemit.eval_direction(jnp.asarray(ref_p), jds, None,
                                jnp.asarray(active)),
           f"{kind} eval_direction")


@pytest.mark.parametrize("kind", KINDS + ("envmap",))
def test_sample_ray_matches_jax(kind):
    """A particle: its origin and direction, weight and position sample.
    The environment map samples the JAX package's own table, as
    ``scene_from_numpy`` carries it across."""
    jemit, pemit = _both(kind)
    _, u1, u2, u3, _, _ = _inputs()
    jray, jw, jps = jemit.sample_ray(jnp.zeros(N), jnp.asarray(u1),
                                     jnp.asarray(u2), jnp.asarray(u3), None)
    pray, pw, pps = pemit.sample_ray(torch.tensor(u1), torch.tensor(u2),
                                     torch.tensor(u3), None)
    _close(pray.o, jray.o, f"{kind} ray.o")
    _close(pray.d, jray.d, f"{kind} ray.d")
    _close(pw, jw, f"{kind} weight")
    for k in ("p", "n", "uv", "pdf"):
        _close(getattr(pps, k), getattr(jps, k), f"{kind} ps.{k}")
    assert np.array_equal(pps.delta.numpy(), np.asarray(jps.delta))
    assert float(np.abs(np.asarray(jw)).max()) > 0


def test_jax_direction_sample_fields():
    """The port's DirectionSample carries the fields of the JAX
    package's that these tests compare."""
    names = set(JDirectionSample.__dataclass_fields__)
    assert {"p", "n", "uv", "d", "dist", "pdf", "delta",
            "emitter_index"} <= names


def test_scene_from_numpy_carries_the_lights(tmp_path):
    """``convert.scene_from_numpy`` of the JAX package's loaded delta-light
    scenes gives the emitters the port's own loader gives, parameter for
    parameter (the projector's bitmap among them)."""
    import dataclasses as dc

    from mitsuba_tpu.utils.load import load_dict as jload_dict
    from mitsuba_tpu_torch import load_dict, scene_from_numpy
    from mitsuba_tpu_torch.utils.bitmap import write_image
    from mitsuba_tpu_torch.utils.scenes import (DELTA_VARIANTS,
                                                delta_lights_dict)
    from torch_parity import export_scene

    png = tmp_path / "p.png"
    write_image(str(png), _rng(3).uniform(size=(6, 8, 3)))
    for v in DELTA_VARIANTS:
        d = delta_lights_dict(8, 8, 1, v, png)
        d["sky" if v == "constant" else "other"] = dict(
            d.get("sky", d.get("other", {"type": "point"})),
            sampling_weight=0.5)
        got = scene_from_numpy(export_scene(jload_dict(d)), device="cpu")
        want = load_dict(d, device="cpu")
        assert [type(e) for e in got.emitters] == \
            [type(e) for e in want.emitters]
        assert got.env_index == want.env_index
        for a, b in zip(got.emitters, want.emitters):
            for f in dc.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, torch.Tensor):
                    np.testing.assert_allclose(x.numpy(), y.numpy(),
                                               rtol=1e-6, err_msg=f.name)
                elif hasattr(x, "data"):   # the projector's bitmap
                    assert torch.equal(x.data, y.data)
                elif not hasattr(x, "value"):
                    assert x == y, f.name
