"""Exact curve prims in the port against mitsuba_tpu, on the CPU: the
swept-sphere helpers, the detached sweep, the interactions in the three
RayFlags modes and their gradients with respect to the control points
and radii, the loader's descriptors, and per-lane renders of
``curves_cornell``.

Both packages build the same prims from the same curve dict (the JAX
loader's ``_make_analytic_prim``, the port's ``analytic_prim``): the
JAX tests' curve (tests/test_analytic_curves.py), as a linear curve and
as a cubic B-spline of 4 sub-segments a parent segment.  Rays are made
from a seed with numpy.  The sub-segments of one parent segment solve
the same canal surface, so a ray's hit on two of them ties to rounding:
for cubic prims the parent segment is what must agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.records import Ray as JRay
from mitsuba_tpu.models import analytic as janalytic
from mitsuba_tpu.utils.load import _make_analytic_prim, load_dict
from mitsuba_tpu_torch import (PathIntegrator, analytic_prim, build_analytic,
                               curves_cornell, sample_rays, scene_from_numpy)
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.models import analytic
from mitsuba_tpu_torch.utils.params import traverse, update
from torch_parity import export_scene, jax_curves_cornell, jax_path_lanes

CP = np.asarray([[-1.0, 0.0, 0.0], [-0.3, 0.4, 0.1],
                 [0.3, -0.2, -0.1], [1.0, 0.1, 0.0]], np.float32)
RADIUS = 0.25
SUBDIV = 4
N_RAYS = 2048
KINDS = ("linearcurve", "bsplinecurve")


def _dict(kind, radius=RADIUS):
    return {"type": kind, "control_points": CP, "radius": radius,
            "subdiv": SUBDIV}


def _both(kind, radius=RADIUS):
    d = _dict(kind, radius)
    return (janalytic.build_analytic(_make_analytic_prim(d, 0, -1)),
            build_analytic(analytic_prim(d), device="cpu"))


def _rays(n=N_RAYS, seed=1):
    """Rays from a sphere of radius 3 toward the curve's box, directions
    not unit (0.7-1.3), a finite maxt on a quarter, a tenth inactive."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3))
    o *= 3.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = r.uniform(-1.2, 1.2, (n, 3)) * np.array([1.0, 0.6, 0.3]) - o
    d *= r.uniform(0.7, 1.3, (n, 1)) / np.linalg.norm(d, axis=1,
                                                      keepdims=True)
    maxt = np.where(r.uniform(size=n) < 0.25, r.uniform(1.0, 5.0, n), np.inf)
    return (o.astype(np.float32), d.astype(np.float32),
            maxt.astype(np.float32), r.uniform(size=n) > 0.1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _same_root(got, want, rtol=1e-5):
    """inf where want is inf, else within rtol."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol)


def test_helpers_match_jax():
    """The rounded cone's roots and first hit, the B-spline evaluation,
    the exact cubic first hit and its Newton solve, on (ray, prim) pairs
    of seeded rays and segments: within 1e-5 of the JAX package's (the
    Newton solve from the candidates' starts, where it converges, its s
    within 1e-3: from a start far from any root ten damped steps amplify
    rounding, and the callers mask those pairs out).  The arrays have the
    shapes of the cubic curve's sweep in ``hits``, so that the JAX
    package's eager operations compile once for both."""
    r = np.random.default_rng(3)
    o, d, maxt, active = _rays()
    jan, an = _both("bsplinecurve")
    k = an.n_curves
    pa = r.uniform(-0.8, 0.8, (1, k, 3)).astype(np.float32)
    pb = (pa + r.uniform(-0.6, 0.6, (1, k, 3))).astype(np.float32)
    ra, rb = (r.uniform(0.05, 0.3, (1, k)).astype(np.float32)
              for _ in range(2))
    oo, dd = o[:, None], d[:, None]
    mt, act = maxt[:, None], active[:, None]
    got = analytic._rounded_cone_roots(_t(oo), _t(dd), _t(pa), _t(pb),
                                       _t(ra), _t(rb))
    want = janalytic._rounded_cone_roots(_j(oo), _j(dd), _j(pa), _j(pb),
                                         _j(ra), _j(rb))
    for a, b in zip(got[:2], want[:2]):
        _same_root(a, b)
    args = (oo, dd, pa, pb, ra, rb, mt, act)
    cand = analytic._rounded_cone_first(*map(_t, args))
    _same_root(cand, janalytic._rounded_cone_first(*map(_j, args)))
    assert 0.05 < np.isfinite(cand.numpy()).mean() < 0.9

    cp = r.uniform(-0.8, 0.8, (1, k, 4, 3)).astype(np.float32)
    cr = r.uniform(0.05, 0.3, (1, k, 4)).astype(np.float32)
    s = r.uniform(-0.2, 1.2, (o.shape[0], k)).astype(np.float32)
    for a, b in zip(analytic._bspline_eval(_t(cp), _t(cr), _t(s)),
                    janalytic._bspline_eval(_j(cp), _j(cr), _j(s))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    w0, w1 = an.cv_w0.numpy()[None], an.cv_w1.numpy()[None]
    cp, cr = an.cv_cp.numpy()[None], an.cv_cr.numpy()[None]
    tk = analytic._rounded_cone_first(
        _t(oo), _t(dd), an.cv_pa[None], an.cv_pb[None],
        an.cv_ra[None] + an.cv_pad[None], an.cv_rb[None] + an.cv_pad[None],
        _t(mt), _t(act))
    got = analytic._cubic_first(_t(oo), _t(dd), _t(cp), _t(cr), _t(w0),
                                _t(w1), _t(mt), _t(act), tk)
    want = janalytic._cubic_first(_j(oo), _j(dd), _j(cp), _j(cr), _j(w0),
                                  _j(w1), _j(mt), _j(act), _j(tk.numpy()))
    _same_root(got, want)
    assert np.isfinite(got.numpy()).any()
    # the Newton solve from the candidates' starts (at the sub-segment's
    # middle), where it converges: t within 1e-5; s within 1e-3, as a
    # grazing ray meets the canal surface along a range of s
    has = np.isfinite(tk.numpy()) & act
    t0 = np.where(has, tk.numpy(), 1.0).astype(np.float32)
    s0 = np.broadcast_to(np.clip(w0 + 0.5 * (w1 - w0), 0, 1),
                         t0.shape).astype(np.float32)
    args = (oo, dd, cp, cr, t0, s0)
    got = analytic._cubic_newton(*map(_t, args))
    want = janalytic._cubic_newton(*map(_j, args))
    conv = has & (np.abs(np.asarray(want[2])) <= 1e-3 * np.asarray(want[3]))
    assert conv.sum() > 0.3 * has.sum()
    for a, b, tol in zip(got[:2], want[:2], (1e-5, 1e-3)):
        np.testing.assert_allclose(a.numpy()[conv], np.asarray(b)[conv],
                                   rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=KINDS)
def hits(request):
    """(kind, the JAX and the port's prims, seeded rays, the JAX package's
    detached hits (t, prim)) of one curve kind, shared by the tests."""
    kind = request.param
    jan, an = _both(kind)
    rays = _rays()
    jt, jp = (np.asarray(x) for x in jan.intersect(*map(_j, rays)))
    return kind, jan, an, rays, jt, jp


def test_intersect_matches_jax(hits):
    """The detached closest hit of seeded rays on the curve's prims: the
    hit flags equal, t within 1e-5 relative, the prim equal (for the
    cubic prims, the parent segment); the any-hit equal."""
    kind, jan, an, (o, d, maxt, active), jt, jp = hits
    t, p = (x.numpy() for x in an.intersect(_t(o), _t(d), _t(maxt),
                                            _t(active)))
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
    per = SUBDIV if kind == "bsplinecurve" else 1
    np.testing.assert_array_equal(p[hit] // per, jp[hit] // per)
    np.testing.assert_array_equal(
        an.any_hit(_t(o), _t(d), _t(maxt), _t(active)).numpy(),
        np.asarray(jan.any_hit(_j(o), _j(d), _j(maxt), _j(active))))


def test_sweep_in_chunks_is_the_dense_sweep(monkeypatch):
    """The curve sweep in chunks of a few (lane, prim) pairs gives the
    dense sweep's t and prim bit for bit (the chunks split the lanes)."""
    _, an = _both("bsplinecurve")
    o, d, maxt, active = (_t(x) for x in _rays(512))
    dense = an.intersect(o, d, maxt, active)
    monkeypatch.setattr(analytic, "CURVE_PAIRS", 7 * an.n_curves + 3)
    chunked = an.intersect(o, d, maxt, active)
    for a, b in zip(dense, chunked):
        assert torch.equal(a, b)


FIELDS = ("t", "p", "n", "sh_s", "sh_t", "uv", "wi")


def _lane_loss(si, w):
    return sum((getattr(si, f) * w[f]).reshape(w[f].shape[0], -1).sum(-1)
               for f in FIELDS)


def _weights(n, seed=2):
    r = np.random.default_rng(seed)
    shape = {"t": (), "uv": (2,)}
    return {f: r.normal(size=(n,) + shape.get(f, (3,))).astype(np.float32)
            for f in FIELDS}


PARAMS = {"linearcurve": ("cv_pa", "cv_pb", "cv_ra", "cv_rb"),
          "bsplinecurve": ("cv_cp", "cv_cr")}


@pytest.mark.parametrize("mode", ["attach", "follow_shape", "detach_shape"])
def test_compute_si_matches_jax(hits, mode):
    """The interaction of each hit in ``mode`` (the JAX package eager):
    every field within 5e-5 of the JAX package's (uv's azimuth modulo
    its wrap); the gradient of a seeded weighted sum of the fields over
    the hit lanes with respect to the control points and radii within
    1e-3 of ``jax.grad``'s, relative to the leaf's largest entry (0 in
    detach_shape)."""
    kind, jan, an, (o, d, maxt, active), jt, jp = hits
    valid = np.isfinite(jt)
    w = _weights(N_RAYS)
    names = PARAMS[kind]

    def jloss(params):
        si = jan.replace(**params).compute_si(
            JRay.make(_j(o), _j(d), _j(maxt)), _j(jt), _j(jp), _j(valid),
            mode=mode)
        si = si.replace(n=si.sh_n)
        return jnp.sum(jnp.where(_j(valid), _lane_loss(si, {
            f: _j(v) for f, v in w.items()}), 0.0)), si

    (_, jsi), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: getattr(jan, k) for k in names})
    leaves = {k: getattr(an, k).clone().requires_grad_() for k in names}
    import dataclasses
    si = dataclasses.replace(an, **leaves).compute_si(
        Ray(o=_t(o), d=_t(d), maxt=_t(maxt)), _t(jt), _t(jp).long(),
        _t(valid), mode=mode)
    loss = torch.sum(torch.where(_t(valid), _lane_loss(si, {
        f: _t(v) for f, v in w.items()}), 0.0))
    if loss.requires_grad:
        loss.backward()
    for f in FIELDS:
        got = getattr(si, f).detach().numpy()[valid]
        want = np.asarray(getattr(jsi, f))[valid]
        if f == "uv":
            diff = np.abs(got - want)
            assert (np.minimum(diff, np.abs(diff - 1.0)) <= 5e-5).all(), f
        else:
            np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5,
                                       err_msg=f)
    for k in names:
        g, want = leaves[k].grad, np.asarray(jg[k])
        if mode == "detach_shape":
            assert g is None or not g.any()
            continue
        assert torch.isfinite(g).all()
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), want, atol=1e-3 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_descriptors_match_load_dict(kind):
    """``analytic_prim`` of a curve dict with a to_world gives the arrays
    and metadata of the JAX package's ``load_dict`` scene, bit for bit."""
    from mitsuba_tpu.core import transform as jtf
    m = np.asarray(jtf.compose(jtf.translate([0.1, -0.2, 0.3]),
                               jtf.scale(0.7)), np.float32)
    d = {**_dict(kind), "to_world": m, "id": "hair"}
    jan = load_dict({"type": "scene", "c": {
        **d, "analytic": True, "bsdf": {"type": "diffuse"}}}).scene_analytic
    an = build_analytic(analytic_prim(d), device="cpu")
    for name in ("cv_pa", "cv_pb", "cv_ra", "cv_rb", "cv_u0", "cv_u1",
                 "cv_cp", "cv_cr", "cv_w0", "cv_w1", "cv_pad", "cv_cubic"):
        np.testing.assert_array_equal(getattr(an, name).numpy(),
                                      np.asarray(getattr(jan, name)), name)
    for name in ("bsdf_index", "emitter_index", "flip_normals", "ids",
                 "any_cubic"):
        assert getattr(an, name) == getattr(jan, name), name
    pts = an.bound_points()
    np.testing.assert_array_equal(pts, jan.bound_points())


@pytest.fixture(scope="module")
def cornells():
    """The JAX twins of curves_cornell(16, 16) (box filter), linear and
    cubic, and the port's scenes converted from them."""
    from mitsuba_tpu.models.film import ReconstructionFilter as JRF
    out = {}
    for kind in KINDS:
        j = jax_curves_cornell(16, 16, kind, rfilter=JRF.box())
        out[kind] = (j, scene_from_numpy(export_scene(j), device="cpu"))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_curves_cornell_per_lane_matches_jax(cornells, kind):
    """curves_cornell holds the JAX twin's prims; the wavefront
    PathIntegrator (6, 5) at 16x16 x 2 spp, lane by lane against the JAX
    package's: >= 99.5 % of lanes within 2e-3, the mean within 2e-3."""
    jscene, scene = cornells[kind]
    mine = curves_cornell(16, 16, kind, device="cpu")
    assert mine.shape_bsdf == scene.shape_bsdf
    a, b = traverse(mine), traverse(scene)
    for k in a:
        if k.startswith("scene_analytic"):
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    ray, _, _, lane = sample_rays(scene, 5, 2)
    got = PathIntegrator(6, 5).sample(scene, ray, lane, 5, torch.ones(
        lane.shape, dtype=torch.bool)).numpy()
    want = jax_path_lanes(jscene, 5, 2)
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3


def test_curve_parameters_are_named_as_in_jax(cornells):
    """The curve's leaves have the JAX package's traverse names, and an
    update of the control points moves the hits."""
    from mitsuba_tpu.utils.params import traverse as jtraverse
    jscene, scene = cornells["bsplinecurve"]
    names = {k for k in traverse(scene) if k.startswith("scene_analytic.cv")}
    assert names == {k for k in jtraverse(jscene)
                     if k.startswith("scene_analytic.cv")}
    cp = traverse(scene)["scene_analytic.cv_cp"]
    moved = update(scene, {"scene_analytic.cv_cp": cp + 0.05})
    assert torch.equal(moved.scene_analytic.cv_cp, cp + 0.05)
