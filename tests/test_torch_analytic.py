"""Exact analytic spheres, disks and cylinders in the port against
mitsuba_tpu, on the CPU: the detached sweep and any-hit, the
interactions in the three RayFlags modes with their gradients, the
sphere light's cone sampling, the scene's queries, bounds and emitter
lookups, per-lane renders of ``analytic_cornell``, the megakernel
fallback, PRB and the analytic silhouette term.

Prims and rays are made from seeds with numpy; both packages build the
same prims from the same descriptors (each package's
``build_analytic``).  The Cornell scenes are the JAX twin of
``analytic_cornell`` (``tests/torch_parity.py::jax_analytic_cornell``,
loaded by ``load_dict`` with ``'analytic': True``) carried across by
``export_scene``.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.records import Ray as JRay
from mitsuba_tpu.models import analytic as janalytic
from mitsuba_tpu_torch import (AnalyticShapes, DirectIntegrator,
                               MegakernelPathIntegrator, PathIntegrator,
                               analytic_cornell, build_analytic, render,
                               sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.core.records import DirectionSample, Ray
from mitsuba_tpu_torch.models import analytic
from mitsuba_tpu_torch.utils.params import traverse, update
from torch_parity import export_scene, jax_analytic_cornell

N_RAYS = 4096
KINDS = ("sphere", "disk", "cylinder", "mixed")


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _prims(kind, seed=0, flip=False):
    """Seeded prim descriptors of one kind (three of it) or of all three
    kinds (two spheres, a disk and a cylinder), overlapping in [-1, 1]^3;
    with ``flip``, the first prim of each type flips its normals."""
    r = np.random.default_rng(seed)
    counts = dict(sphere=3, disk=3, cylinder=3) if kind != "mixed" else \
        dict(sphere=2, disk=1, cylinder=1)
    out = []
    for k in ("sphere", "disk", "cylinder"):
        if kind not in (k, "mixed"):
            continue
        for i in range(counts[k]):
            meta = (i % 2, -1, flip and i == 0, f"{k}{i}")
            c = r.uniform(-0.7, 0.7, 3).astype(np.float32)
            if k == "sphere":
                out.append(("sphere", c, float(r.uniform(0.3, 0.6)), *meta))
            elif k == "disk":
                n = _unit(r.normal(size=3))
                su = _unit(np.cross(n, r.normal(size=3)))
                sv = np.cross(n, su)
                out.append(("disk", c, (su * r.uniform(0.3, 0.7)).astype(
                    np.float32), (sv * r.uniform(0.3, 0.7)).astype(np.float32),
                    n.astype(np.float32), *meta))
            else:
                out.append(("cylinder", c, _unit(r.normal(size=3)).astype(
                    np.float32), float(r.uniform(0.5, 1.2)),
                    float(r.uniform(0.15, 0.4)), *meta))
    return out


def _rays(n=N_RAYS, seed=1):
    """Rays from a sphere of radius 4 toward points in [-1, 1]^3, with
    non-unit directions (a sensor's rays are not normalised exactly), a
    finite maxt on a quarter of them and a tenth inactive."""
    r = np.random.default_rng(seed)
    o = _unit(r.normal(size=(n, 3))) * 4.0
    d = r.uniform(-1, 1, (n, 3)) - o
    d = _unit(d) * r.uniform(0.7, 1.3, (n, 1))
    maxt = np.where(r.uniform(size=n) < 0.25, r.uniform(1.0, 6.0, n), np.inf)
    active = r.uniform(size=n) > 0.1
    return (o.astype(np.float32), d.astype(np.float32),
            maxt.astype(np.float32), active)


def _both(prims):
    return janalytic.build_analytic(prims), build_analytic(prims,
                                                           device="cpu")


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("kind", KINDS)
def test_intersect_matches_jax(kind):
    """The detached closest hit and the any-hit of 4,096 seeded rays: the
    hit flags equal, t within 1e-5 relative, the prim equal on >= 99.9 %
    (ties aside)."""
    jan, an = _both(_prims(kind))
    o, d, maxt, active = _rays()
    jt, jp = (np.asarray(x) for x in jan.intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt),
        jnp.asarray(active)))
    t, p = an.intersect(_t(o), _t(d), _t(maxt), _t(active))
    t, p = t.numpy(), p.numpy()
    hit, jhit = np.isfinite(t), np.isfinite(jt)
    np.testing.assert_array_equal(hit, jhit)
    assert 0.1 < hit.mean() < 0.95
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
    assert (p[hit] == jp[hit]).mean() >= 0.999
    np.testing.assert_array_equal(
        an.any_hit(_t(o), _t(d), _t(maxt), _t(active)).numpy(),
        np.asarray(jan.any_hit(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(maxt), jnp.asarray(active))))


FIELDS = ("t", "p", "n", "sh_s", "sh_t", "uv", "wi")
PARAMS = ("sp_center", "sp_radius", "dk_center", "dk_su", "dk_sv", "dk_n",
          "cy_p0", "cy_axis", "cy_len", "cy_radius")


def _weights(n, seed=2):
    r = np.random.default_rng(seed)
    return {f: r.normal(size=(n,) + ((3,) if f not in ("t", "uv") else
                                     (2,) if f == "uv" else ())
                        ).astype(np.float32) for f in FIELDS}


def _uv_close(a, b, tol):
    """uv within tol, an azimuth's wrap at 0 / 1 aside."""
    diff = np.abs(a - b)
    return np.minimum(diff, np.abs(diff - 1.0)) <= tol


def _lane_loss(si, w):
    """Each lane's seeded weighted sum of the interaction's fields."""
    return sum((getattr(si, "sh_n" if f == "n" else f) * w[f]).reshape(
        w[f].shape[0], -1).sum(-1) for f in FIELDS)


def _close_lanes(got, want, rtol):
    """Lanes within rtol of want, relative to 1e-3 of the largest |want|
    at least."""
    return np.abs(got - want) <= rtol * np.maximum(
        np.abs(want), 1e-3 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["attach", "follow_shape", "detach_shape"])
def test_compute_si_matches_jax(mode):
    """The interaction of each hit of 4,096 rays on mixed prims (one of
    each type flipped) in ``mode``: every field within 1e-5 of the JAX
    package's; lane by lane, the derivative of a seeded weighted sum of
    the fields along seeded tangents of the prims' parameters and of the
    rays within 1e-4 of ``jax.jvp``'s (eager: jit reassociates the
    quadratics, which moves the JAX package's own derivatives by up to
    4e-3 on grazing lanes); and the port's autograd gradients, with
    respect to the parameters and per lane the rays, equal to its
    forward-mode derivatives within 1e-4.  In attach mode the JAX
    package's reverse-mode gradient is NaN (its sphere branch, evaluated
    on the other types' lanes, gives 0 * inf at arccos' ends); the
    port's is finite."""
    prims = _prims("mixed", seed=4, flip=True)
    jan, an = _both(prims)
    o, d, maxt, active = _rays(seed=5)
    jt, jp = (np.asarray(x) for x in jan.intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt),
        jnp.asarray(active)))
    valid = np.isfinite(jt)
    w = _weights(N_RAYS)
    r = np.random.default_rng(6)
    tan = {k: r.normal(size=getattr(an, k).shape).astype(np.float32)
           for k in PARAMS}
    tan_o, tan_d = (r.normal(size=(N_RAYS, 3)).astype(np.float32)
                    for _ in range(2))

    def jlanes(params, o_, d_):
        si = jan.replace(**params).compute_si(
            JRay.make(o_, d_, jnp.asarray(maxt)), jnp.asarray(jt),
            jnp.asarray(jp), jnp.asarray(valid), mode=mode)
        return _lane_loss(si, w), si

    jparams = {k: getattr(jan, k) for k in PARAMS}
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    (_, jsi), (jvp_p, _) = jax.jvp(
        lambda p: jlanes(p, jo, jd), (jparams,),
        ({k: jnp.asarray(v) for k, v in tan.items()},))
    _, jvp_r = jax.jvp(lambda o_, d_: jlanes(jparams, o_, d_)[0], (jo, jd),
                       (jnp.asarray(tan_o), jnp.asarray(tan_d)))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jnp.where(
        jnp.asarray(valid), jlanes(p, jo, jd)[0], 0.0))))(jparams)
    assert np.isfinite(np.asarray(jg["sp_center"])).all() == (mode != "attach")

    fw = torch.autograd.forward_ad
    wt = {f: _t(v) for f, v in w.items()}

    def lanes(sh, o_, d_):
        si = sh.compute_si(Ray(o=o_, d=d_, maxt=_t(maxt)), _t(jt),
                           _t(jp).long(), _t(valid), mode=mode)
        return _lane_loss(si, wt), si

    with fw.dual_level():
        out, si = lanes(dataclasses.replace(an, **{
            k: fw.make_dual(getattr(an, k), _t(tan[k])) for k in PARAMS}),
            _t(o), _t(d))
        jvp = fw.unpack_dual(out).tangent
        jvp = torch.zeros(N_RAYS) if jvp is None else jvp
        jvp_ray = fw.unpack_dual(lanes(an, fw.make_dual(_t(o), _t(tan_o)),
                                       fw.make_dual(_t(d), _t(tan_d)))[0]
                                 ).tangent
    leaves = {k: getattr(an, k).clone().requires_grad_() for k in PARAMS}
    to, td = _t(o).requires_grad_(), _t(d).requires_grad_()
    torch.sum(torch.where(_t(valid), lanes(dataclasses.replace(
        an, **leaves), to, td)[0], 0.0)).backward()

    for f in FIELDS:
        got = getattr(si, f).detach().numpy()[valid]
        want = np.asarray(getattr(jsi, f))[valid]
        if f == "uv":
            assert _uv_close(got, want, 1e-5).all(), f
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
    np.testing.assert_array_equal(si.shape_index.numpy(),
                                  np.where(valid, jp, -1))
    got_p, got_r = jvp.detach().numpy()[valid], jvp_ray.numpy()[valid]
    if mode == "detach_shape":
        assert not got_p.any() and not np.asarray(jvp_p)[valid].any()
    else:
        assert _close_lanes(got_p, np.asarray(jvp_p)[valid], 1e-4).all()
    assert _close_lanes(got_r, np.asarray(jvp_r)[valid], 1e-4).all()
    # the port's reverse mode against its forward mode
    g_dot = sum(float(torch.sum(leaves[k].grad * _t(tan[k])))
                for k in PARAMS if leaves[k].grad is not None)
    assert abs(g_dot - float(got_p.sum())) <= 1e-4 * np.abs(got_p).sum()
    per_lane = (torch.sum(to.grad * _t(tan_o), -1)
                + torch.sum(td.grad * _t(tan_d), -1)).numpy()[valid]
    assert torch.isfinite(to.grad).all() and torch.isfinite(td.grad).all()
    assert _close_lanes(per_lane, got_r, 1e-4).all()


# --------------------------------------------------------- the sphere light

def test_sphere_geom_matches_jax():
    """Cone sampling toward a sphere light (the reference's low-distortion
    map, and its Taylor branch from far away), its pdf, and the uniform
    positions from inside: within 1e-5 of the JAX package's; inside,
    cone_pdf_direction's area fallback."""
    c, rad = np.array([0.2, -0.1, 0.3], np.float32), np.float32(0.4)
    jgeom = janalytic.SphereGeom(center=jnp.asarray(c), radius=jnp.asarray(rad))
    geom = analytic.SphereGeom(center=_t(c), radius=_t(rad))
    r = np.random.default_rng(7)
    n = 2048
    u = r.uniform(size=(n, 2)).astype(np.float32)
    dirs = _unit(r.normal(size=(n, 3)))
    # near (1.2 radii) to far (200: sin^2 theta_max below the Taylor
    # switch), and inside
    dist = np.concatenate([r.uniform(0.48, 4.0, n // 2),
                           r.uniform(30.0, 200.0, n // 4),
                           r.uniform(0.0, 0.35, n // 4)])
    ref = (c + dirs * dist[:, None]).astype(np.float32)
    got = geom.cone_sample_direction(_t(ref), _t(u))
    want = jgeom.cone_sample_direction(jnp.asarray(ref), jnp.asarray(u))
    outside = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), outside)
    assert outside.sum() == 3 * n // 4
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy()[outside], np.asarray(b)[outside],
                                   rtol=1e-5, atol=1e-5)
    ps, jps = geom.sample_position(None, _t(u)), jgeom.sample_position(
        None, jnp.asarray(u))
    for f in ("p", "n", "pdf"):
        np.testing.assert_allclose(getattr(ps, f).numpy(),
                                   np.asarray(getattr(jps, f)), rtol=1e-5,
                                   atol=1e-6)
    # the pdf of the samples from outside, the area pdf from inside
    p = np.where(outside[:, None], got[0].numpy(), ps.p.numpy())
    nrm = np.where(outside[:, None], got[1].numpy(), ps.n.numpy())
    delta = p - ref
    dd = np.linalg.norm(delta, axis=-1)
    ds = DirectionSample(p=_t(p), n=_t(nrm), uv=_t(u), d=_t(delta / dd[:, None]),
                         dist=_t(dd), pdf=torch.zeros(n), delta=torch.zeros(
                             n, dtype=torch.bool),
                         emitter_index=torch.zeros(n, dtype=torch.int64))
    from mitsuba_tpu.core.records import DirectionSample as JDS
    jds = JDS(p=jnp.asarray(p), n=jnp.asarray(nrm), uv=jnp.asarray(u),
              d=jnp.asarray(delta / dd[:, None]), dist=jnp.asarray(dd),
              pdf=jnp.zeros(n), delta=jnp.zeros(n, bool),
              emitter_index=jnp.zeros(n, jnp.int32))
    np.testing.assert_allclose(geom.cone_pdf_direction(_t(ref), ds).numpy(),
                               np.asarray(jgeom.cone_pdf_direction(
                                   jnp.asarray(ref), jds)), rtol=1e-5)


# ------------------------------------------------------------ the scenes

@pytest.fixture(scope="module")
def cornells():
    """The JAX twins of analytic_cornell (16x16, box filter), with and
    without the sphere light, and the port's scenes converted from them."""
    out = {}
    for sl in (False, True):
        from mitsuba_tpu.models.film import ReconstructionFilter as JRF
        j = jax_analytic_cornell(16, 16, sphere_light=sl, rfilter=JRF.box())
        out[sl] = (j, scene_from_numpy(export_scene(j), device="cpu"))
    return out


@pytest.mark.parametrize("sphere_light", [False, True])
def test_analytic_cornell_matches_jax_twin(cornells, sphere_light):
    """``analytic_cornell`` holds the JAX twin's prims, BSDFs, shape slots,
    emitter owners and bounding sphere (its leaves within 1e-6)."""
    jscene, conv = cornells[sphere_light]
    mine = analytic_cornell(16, 16, sphere_light=sphere_light, device="cpu")
    for f in ("shape_bsdf", "shape_emitter", "emitter_shape"):
        assert getattr(mine, f) == tuple(getattr(jscene, f)) \
            == getattr(conv, f), f
    assert mine._analytic_base() == len(jscene.meshes)
    assert mine._instance_base() == jscene._instance_base()
    assert mine.scene_radius == pytest.approx(float(jscene.scene_radius),
                                              rel=1e-6)
    np.testing.assert_allclose(mine.scene_center, np.asarray(
        jscene.scene_center), atol=1e-6)
    a, b = traverse(mine), traverse(conv)
    assert set(a) == set(b)
    for k in a:
        if k.startswith("sensor") or k.startswith("meshes"):
            continue      # the film's filter differs; the meshes' own test
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_scene_queries_match_jax(cornells):
    """The scene's closest hit (mesh query merged with the analytic sweep),
    its interaction, the any-hit, and the emitter lookups of the hits
    (eval_emitter_hit, pdf_emitter_direction) and of NEE toward the sphere
    light, on 4,096 seeded rays from inside the box: hits equal on >= 99.9
    % of rays, t and the fields within 1e-5, radiance and pdfs within
    1e-5 relative; NEE from a point on the lamp is refused (the port's
    self-lit guard, which the JAX package lacks)."""
    jscene, scene = cornells[True]
    r = np.random.default_rng(8)
    n = N_RAYS
    o = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 2] = r.uniform(0.6, 0.95, n)
    d = _unit(r.normal(size=(n, 3))).astype(np.float32)
    maxt = np.where(r.uniform(size=n) < 0.3, r.uniform(0.2, 2.0, n),
                    np.inf).astype(np.float32)
    active = np.ones(n, bool)
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt))
    ray = Ray(o=_t(o), d=_t(d), maxt=_t(maxt))
    jsi = jscene.ray_intersect(jray, jnp.asarray(active))
    si = scene.ray_intersect(ray, _t(active), scene.trace_ctx())
    jshape = np.asarray(jsi.shape_index)
    same = si.shape_index.numpy() == jshape
    assert same.mean() >= 0.999
    hit = same & (jshape >= 0)
    assert (jshape >= scene._analytic_base()).mean() > 0.05
    for f in ("t", "p", "n", "wi"):
        np.testing.assert_allclose(getattr(si, f).numpy()[hit],
                                   np.asarray(getattr(jsi, f))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    occ = scene.ray_test(ray, _t(active), scene.trace_ctx()).numpy()
    jocc = np.asarray(jscene.ray_test(jray, jnp.asarray(active)))
    assert (occ == jocc).mean() >= 0.999
    # emitter lookups at the hits, seen from the rays' origins
    le, pdf = scene.eval_emitter_hit(si, ray.o, _t(hit))
    jle, jpdf = jscene.eval_emitter_hit(jsi, jray.o, jnp.asarray(hit))
    lamp = hit & (jshape == scene.emitter_shape[0])
    assert lamp.sum() > 5
    np.testing.assert_allclose(le.numpy()[hit], np.asarray(jle)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(pdf.numpy()[hit], np.asarray(jpdf)[hit],
                               rtol=1e-5)
    # NEE toward the sphere light from the hits
    u1, u2 = (r.uniform(size=s).astype(np.float32) for s in (n, (n, 2)))
    ds, wgt, ok = scene.sample_emitter_direction(si, _t(u1), _t(u2), _t(hit),
                                                 scene.trace_ctx())
    jds, jwgt, jok = jscene.sample_emitter_direction(
        jsi, jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(hit))
    # the port gives a shading point on the lamp no NEE toward it (the
    # self-lit guard); the JAX package samples it
    self_lit = hit & (jshape == scene.emitter_shape[0])
    assert self_lit.sum() > 5 and not ok.numpy()[self_lit].any()
    both = ok.numpy() & np.asarray(jok)
    assert (ok.numpy() == np.asarray(jok))[~self_lit].mean() >= 0.999 \
        and both.sum() > 100
    for a, b in ((ds.p, jds.p), (ds.pdf, jds.pdf), (wgt, jwgt)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        scene.pdf_emitter_direction(si.p, ds, _t(both)).numpy()[both],
        np.asarray(jscene.pdf_emitter_direction(jsi.p, jds,
                                                jnp.asarray(both)))[both],
        rtol=1e-4)


def _lanes(scene, integ, spp=2, seed=5):
    ray, _, _, lane = sample_rays(scene, seed, spp)
    return integ.sample(scene, ray, lane, seed,
                        torch.ones(lane.shape, dtype=torch.bool)).numpy()


def _jlanes(jscene, integ, spp=2, seed=5):
    from mitsuba_tpu.models.integrators import sample_rays as jsample_rays
    ray, _, _, lane = jsample_rays(jscene, jnp.uint32(seed), spp)
    return np.asarray(integ.sample(jscene, ray, lane, jnp.uint32(seed),
                                   jnp.ones(lane.shape, bool)))


@pytest.mark.parametrize("sphere_light", [False, True])
@pytest.mark.parametrize("kind", ["path", pytest.param(
    "direct", marks=pytest.mark.slow)])
def test_render_per_lane_matches_jax(cornells, kind, sphere_light):
    """The wavefront PathIntegrator (6, 5) and the DirectIntegrator on the
    analytic Cornell box at 16x16 x 2 spp, lane by lane against the JAX
    package's: >= 99.5 % of lanes within 2e-3, the mean within 2e-3."""
    from mitsuba_tpu.models import integrators as jint
    jscene, scene = cornells[sphere_light]
    integ, jinteg = ((PathIntegrator(6, 5), jint.PathIntegrator(6, 5))
                     if kind == "path" else
                     (DirectIntegrator(), jint.DirectIntegrator()))
    got, want = _lanes(scene, integ), _jlanes(jscene, jinteg)
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def test_megapath_falls_back(cornells, caplog):
    """MegakernelPathIntegrator refuses analytic prims, as the JAX
    package's megakernel_applicable does: it logs the fallback, naming
    them, and gives the PathIntegrator's lanes bit for bit."""
    from mitsuba_tpu.ops.pallas.megakernel import megakernel_applicable
    from mitsuba_tpu_torch.ops.megakernel import plugin_subset_ok
    jscene, scene = cornells[False]
    assert not megakernel_applicable(jscene) and not plugin_subset_ok(scene)
    with caplog.at_level(logging.INFO):
        got = _lanes(scene, MegakernelPathIntegrator(6, 5))
    assert "analytic prims" in caplog.text
    np.testing.assert_array_equal(got, _lanes(scene, PathIntegrator(6, 5)))
    with pytest.raises(ValueError, match="analytic prims"):
        _lanes(scene, MegakernelPathIntegrator(6, 5, strict=True))


def test_traverse_names_match_jax(cornells):
    """The scene parameters name the prims as the JAX package's traverse
    does (scene_analytic.sp_center, ...), and update moves them."""
    from mitsuba_tpu.utils.params import traverse as jtraverse
    jscene, scene = cornells[True]
    names = {k for k in traverse(scene) if k.startswith("scene_analytic")}
    jnames = {k for k in jtraverse(jscene) if k.startswith("scene_analytic")}
    assert names == jnames and "scene_analytic.sp_center" in names
    moved = update(scene, {"scene_analytic.sp_radius": torch.tensor(
        [0.3, 0.1])})
    assert moved.scene_analytic.sp_radius.tolist() == pytest.approx([0.3, 0.1])
    assert scene.scene_analytic.sp_radius.tolist() == pytest.approx(
        [0.35, 0.12])


def test_curve_prims_raise():
    """Curve prims are ported (Queue 1 item 5c (ii)): build_analytic,
    analytic_prim and analytic_from_numpy no longer raise for them, and
    give the JAX package's arrays; an unknown shape type still raises."""
    desc = ("curve", np.zeros(3), np.ones(3), 0.1, 0.1, 0.0, 1.0, 0, -1,
            False, "c")
    an = build_analytic([desc], device="cpu")
    assert an.n_curves == 1 and not an.any_cubic
    assert len(analytic.analytic_prim({"type": "linearcurve",
                                       "control_points": np.zeros((2, 3))})) \
        == 1
    with pytest.raises(ValueError, match="unknown analytic shape"):
        analytic.analytic_prim({"type": "torus"})
    jan = janalytic.build_analytic([desc])
    arrays = {f.name: np.asarray(getattr(jan, f.name))
              for f in dataclasses.fields(jan) if f.name[:3] in (
                  "sp_", "dk_", "cy_", "cv_")}
    arrays.update(bsdf_index=[0], emitter_index=[-1], flip_normals=[False],
                  ids=["c"])
    from mitsuba_tpu_torch.convert import analytic_from_numpy
    conv = analytic_from_numpy(arrays, device="cpu")
    for k in arrays:
        if k[:3] == "cv_":
            np.testing.assert_array_equal(getattr(conv, k).numpy(), arrays[k])
            np.testing.assert_array_equal(getattr(an, k).numpy(), arrays[k])
    assert isinstance(analytic_from_numpy([{"type": "sphere", "radius": 0.5}],
                                          device="cpu"), AnalyticShapes)


# ------------------------------------------------- gradients (PRB, boundary)

RADIUS = "scene_analytic.sp_radius"


def test_prb_radius_gradient_matches_forward_mode(cornells):
    """prb_render's gradient of a seeded weighted image sum with respect to
    the spheres' radii (16x16 x 2 spp) is finite, nonzero on the ball (the
    lamp's radius moves only boundaries, its constant radiance and its
    detached NEE samples: test_prb_radius_gradient_matches_jax holds its
    0), and equals prb_render_forward's derivative along a tangent within
    1e-4."""
    from mitsuba_tpu_torch import PRBIntegrator, prb_render, \
        prb_render_forward
    _, scene = cornells[True]
    w = torch.tensor(np.random.default_rng(9).uniform(
        size=(16, 16, 3)).astype(np.float32))
    leaf = traverse(scene)[RADIUS].clone().requires_grad_()
    integ = PRBIntegrator(6, 5)
    torch.sum(prb_render(update(scene, {RADIUS: leaf}), integ, 3, 2,
                         device="cpu") * w).backward()
    g = leaf.grad
    assert torch.isfinite(g).all() and g[0] != 0
    tangent = torch.tensor([1.0, -0.5])
    _, dimg = prb_render_forward(scene, {RADIUS: tangent}, integ, 3, 2,
                                 device="cpu")
    fwd = float(torch.sum(dimg * w))
    assert abs(float(g @ tangent) - fwd) <= 1e-4 * abs(fwd)


@pytest.mark.slow
def test_prb_radius_gradient_matches_jax(cornells, monkeypatch):
    """prb_render's gradient of both spheres' radii (16x16 x 2 spp)
    against the JAX package's prb_render.  As it is, JAX gives the lamp's
    radius ~1e7: on a few lanes whose shading point lies on the lamp, the
    NEE sample of the lamp lands within 1e-6 of that point, float32
    rounding turns the cosine of that chord positive, and the attached
    NEE geometry (direction and jac, derivatives ~ 1 / chord) blows up
    (ROADMAP.md Queue 3).  A convex emitter does not light itself, so
    the witness is JAX's adjoint with the NEE term of the lanes whose
    sample lies within 1e-4 of the shading point taken out: it leaves the
    ball's gradient as it was and gives the lamp 0, the port's value.
    The ball within 1e-3 relative, the lamp within 1e-3 of the ball's
    magnitude."""
    from mitsuba_tpu.models.integrators import PRBIntegrator as JPRB
    from mitsuba_tpu.models.integrators import prb as jprb_mod
    from mitsuba_tpu.models.integrators import prb_render as jprb_render
    from mitsuba_tpu_torch import PRBIntegrator, prb_render
    jscene, scene = cornells[True]
    w = np.random.default_rng(9).uniform(size=(16, 16, 3)).astype(np.float32)

    def jgrad():
        return np.asarray(jax.grad(lambda radius: jnp.sum(jprb_render(
            jscene.replace(scene_analytic=jscene.scene_analytic.replace(
                sp_radius=radius)), JPRB(6, 5), 3, 2) * w))(
                    jscene.scene_analytic.sp_radius))

    as_is = jgrad()
    attached = jprb_mod._nee_geometry_attached

    def no_self_nee(si, ds):
        d, jac = attached(si, ds)
        self_lit = jnp.sum((ds.p - si.p) ** 2, -1) < 1e-8
        return d, jnp.where(self_lit, 0.0, jac)

    monkeypatch.setattr(jprb_mod, "_nee_geometry_attached", no_self_nee)
    want = jgrad()
    leaf = traverse(scene)[RADIUS].clone().requires_grad_()
    torch.sum(prb_render(update(scene, {RADIUS: leaf}), PRBIntegrator(6, 5),
                         3, 2, device="cpu") * _t(w)).backward()
    got = leaf.grad.numpy()
    assert abs(as_is[1]) > 1e6 and as_is[0] == want[0]
    assert abs(got[0] - want[0]) <= 1e-3 * abs(want[0])
    assert abs(got[1] - want[1]) <= 1e-3 * abs(want[0])


BOUNDARY = dict(n=1024, n_sub=1, depth=2, seed=11)
TANGENTS = {"sphere": ("scene_analytic.sp_center", 0, 0),
            "disk": ("scene_analytic.dk_center", 0, 1),
            "pose": ("sensor.to_world", 0, 3)}


@pytest.fixture(scope="module")
def jax_contours(cornells):
    """The JAX package's analytic_boundary_grads on the box-filtered twin
    (1,024 samples, one path a side, depth 2) under a seeded adjoint
    image, jitted, with what its S closes over: each lane's curve, angle,
    film normal and coefficient, and the closed form S re-attaches."""
    from mitsuba_tpu.models.integrators import projective as jproj
    from mitsuba_tpu.models.integrators.path import PathIntegrator as JPath
    from mitsuba_tpu.models.integrators.prb import _float_partition
    jscene, scene = cornells[False]
    w = np.random.default_rng(12).normal(size=(16, 16, 3)).astype(np.float32)
    seen = []

    class _Grad:
        """jax with grad recording the function it differentiates."""

        def __getattr__(self, name):
            return getattr(jax, name)

        def grad(self, fn):
            seen.append(fn)
            return jax.grad(fn)

    def run(scene, w_):
        grads = jproj.analytic_boundary_grads(
            scene, JPath(max_depth=BOUNDARY["depth"]), w_, BOUNDARY["seed"],
            n_samples=BOUNDARY["n"], n_sub=BOUNDARY["n_sub"])
        S = seen[-1]
        cells = dict(zip(S.__code__.co_freevars,
                         (c.cell_contents for c in S.__closure__)))
        seen.append(cells["x_of"])
        return grads, {k: cells[k] for k in ("coeff", "idx", "theta",
                                             "m_hat")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jproj, "jax", _Grad())
        grads, cells = jax.jit(run)(jscene, jnp.asarray(w))
    cells["x_of"] = seen[-1]
    cells["rebuild"] = _float_partition(jscene)[1]
    return dict(grads=grads, cells=cells, w=w)


def _jax_term_tangent(jscene, cells, case):
    """Each lane's derivative of the JAX package's S terms along one
    parameter of ``case``."""
    from mitsuba_tpu.models.integrators import projective as jproj
    from mitsuba_tpu.models.integrators.prb import _float_partition
    key, row, col = TANGENTS[case]
    floats, _, cot = _float_partition(jscene)
    tan = cot([jnp.zeros_like(x) for x in floats])
    if case == "pose":
        tan = tan.replace(sensor=tan.sensor.replace(
            to_world=tan.sensor.to_world.at[row, col].set(1.0)))
    else:
        field = key.split(".")[-1]
        tan = tan.replace(scene_analytic=tan.scene_analytic.replace(**{
            field: getattr(tan.scene_analytic, field).at[row, col].set(1.0)}))
    c = cells

    def terms(fl):
        sc = c["rebuild"](fl)
        n = c["theta"].shape[0]
        cam = jnp.broadcast_to(sc.sensor.to_world[:3, 3], (n, 3))
        x = c["x_of"](c["theta"], c["idx"], sc.scene_analytic, cam)
        uv = jnp.nan_to_num(jproj._project(sc.sensor, x,
                                           jnp.ones((n,), bool))[0])
        return c["coeff"] * jnp.sum(c["m_hat"] * uv, -1)

    return np.asarray(jax.jvp(terms, (floats,),
                              (_float_partition(tan)[0],))[1])


@pytest.mark.parametrize("case", list(TANGENTS))
def test_analytic_boundary_per_lane_matches_jax(cornells, jax_contours,
                                                case):
    """analytic_boundary_grads' samples (1,024 on the box-filtered twin)
    lane by lane against the JAX package's: the curve and angle equal,
    the coefficient within 1e-3 relative and each lane's derivative of
    its S term along the ball's x (sphere), the disk's y (disk) or the
    camera's x translation (pose) within 1e-3 relative on >= 99 % of
    lanes; the summed gradient of that leaf within 1e-3."""
    from mitsuba_tpu_torch.models.integrators import projective
    from mitsuba_tpu.models.integrators.prb import _float_partition
    from mitsuba_tpu.utils.params import traverse as jtraverse
    jscene, scene = cornells[False]
    cells, w = jax_contours["cells"], jax_contours["w"]
    key, row, col = TANGENTS[case]
    seed_b = (BOUNDARY["seed"] & 0xFFFFFFFF) ^ projective._ANALYTIC_SALT
    det = projective._detached(scene)
    s = projective._contour_pass(
        det, PathIntegrator(BOUNDARY["depth"], 5), _t(w), seed_b,
        BOUNDARY["n"], BOUNDARY["n_sub"], 0.75)
    np.testing.assert_array_equal(s.idx.numpy(), np.asarray(cells["idx"]))
    np.testing.assert_allclose(s.theta.numpy(), np.asarray(cells["theta"]),
                               rtol=1e-7)
    want_c = np.asarray(cells["coeff"])
    assert (want_c != 0).sum() > 50
    close = _close_lanes(s.coeff.numpy(), want_c, 1e-3)
    assert close.mean() >= 0.99
    tan = torch.zeros_like(traverse(scene)[key])
    tan[row, col] = 1.0
    fw = torch.autograd.forward_ad
    keep = torch.arange(BOUNDARY["n"])
    with fw.dual_level():
        sc = update(det, {key: fw.make_dual(traverse(det)[key], tan)})
        got = fw.unpack_dual(projective._contour_terms(sc, s, keep)).tangent
    want = _jax_term_tangent(jscene, cells, case)
    assert np.abs(want).sum() > 0
    assert _close_lanes(got.numpy(), want, 1e-3).mean() >= 0.99
    g = projective.analytic_boundary_grads(
        scene, PathIntegrator(BOUNDARY["depth"], 5), _t(w), BOUNDARY["seed"],
        n_samples=BOUNDARY["n"], n_sub=BOUNDARY["n_sub"],
        params={key: traverse(scene)[key]})[key]
    jg = np.asarray(jtraverse(_float_partition(jscene)[2](
        jax_contours["grads"]))[key])
    assert np.linalg.norm(g.numpy() - jg) <= 1e-3 * np.linalg.norm(jg)
