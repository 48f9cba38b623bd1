"""Two repairs of the port, on the CPU: the row gathers whose backward
adds in a fixed order (``ops/gather.py``), and the self-lit NEE guard of
the sphere lamp (``Scene.sample_emitter_direction``).

- ``gather_rows``' CPU backward is ``index_select``'s own, bit for bit,
  and so are the gradients of a PRB step that reach the mesh vertices
  through ``compute_si``; the card's ``segment_sum`` is held against the
  CPU's ``index_add`` here and repeats bit for bit in
  tests/test_torch_cuda.py.
- The guiding grid's update and the film's ``splat`` add through
  ``index_add_rows``: on the CPU exactly what ``index_add`` gave, on the
  card a fixed-point sum whose bits repeat (held in
  tests/test_torch_cuda.py); the fixed-point sum itself is held here
  against a float64 scatter.
- A shading point on the sphere lamp that draws the lamp gets no NEE:
  ok False, weight 0, and PRB's adjoint gives the lamp's radius a
  finite gradient.
"""
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad

from mitsuba_tpu_torch import (PRBIntegrator, analytic_cornell, big_scene,
                               prb_render)
from mitsuba_tpu_torch.core.records import Ray
from mitsuba_tpu_torch.models.film import ReconstructionFilter, splat
from mitsuba_tpu_torch.models.integrators.guiding import GridDistr
from mitsuba_tpu_torch.ops.gather import (fixed_point_sum, gather_rows,
                                          index_add_rows, segment_sum)
from mitsuba_tpu_torch.utils.params import traverse, update


def _heavy(n=20_000, rows=300, width=26, seed=0):
    """An index where half the lanes name row 3 (a floor face's share)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, rows, (n,), generator=g)
    idx[: n // 2] = 3
    return (torch.randn(rows, width, generator=g), idx,
            torch.randn(n, width, generator=g))


def test_gather_rows_cpu_bits_are_index_selects():
    """On the CPU the values, the gradient (index_add in lane order) and
    the forward-mode tangent of gather_rows equal index_select's bit for
    bit."""
    x, idx, w = _heavy()
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = gather_rows(a, idx), b.index_select(0, idx)
    assert torch.equal(ya, yb)
    torch.sum(ya * w).backward()
    torch.sum(yb * w).backward()
    assert torch.equal(a.grad, b.grad)
    tan = torch.randn_like(x)
    with fwad.dual_level():
        t = fwad.unpack_dual(gather_rows(fwad.make_dual(x, tan), idx)).tangent
    assert torch.equal(t, tan.index_select(0, idx))


@pytest.mark.parametrize("rows", [1, 7, 300, 5000])
def test_segment_sum_matches_index_add(rows):
    """The card's order of sums (stable sort, blocks of 8, level by level),
    run here: against the float64 sums, no worse than index_add's lane
    order and within 1e-6 of the largest row; rows no lane names are
    exactly 0; (N, 4, 3) values keep their shape."""
    x, idx, w = _heavy(rows=rows)
    idx = idx % rows
    exact = torch.zeros(rows, w.shape[1], dtype=torch.float64).index_add_(
        0, idx, w.double())
    seq = torch.zeros(rows, w.shape[1]).index_add_(0, idx, w)
    got = segment_sum(idx, w, rows)
    err = float((got.double() - exact).abs().max())
    assert err <= float((seq.double() - exact).abs().max()) + 1e-12
    assert err <= 1e-6 * float(exact.abs().max())
    unused = torch.ones(rows + 3, dtype=torch.bool)
    unused[idx] = False
    assert not segment_sum(idx, w, rows + 3)[unused].any()
    w3 = w[:, :12].reshape(-1, 4, 3)
    assert segment_sum(idx, w3, rows).shape == (rows, 4, 3)


def test_prb_vertex_gradient_bits_unchanged():
    """A PRB step's gradient with respect to big_scene's ball vertices
    (8x8 x 2 spp, the shading gathers through gather_rows) equals, bit
    for bit, the same step with every gather_rows replaced by
    index_select (the parent's gathers)."""
    import mitsuba_tpu_torch.models.instancing as inst_mod
    import mitsuba_tpu_torch.models.scene as scene_mod
    scene = big_scene(8, 8, subdiv=2, device="cpu")
    key = "meshes.8.vertices"
    w = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(1))

    def grad():
        leaf = traverse(scene)[key].clone().requires_grad_()
        torch.sum(prb_render(update(scene, {key: leaf}), PRBIntegrator(4, 5),
                             3, 2, device="cpu") * w).backward()
        return leaf.grad

    got = grad()
    saved = scene_mod.gather_rows
    scene_mod.gather_rows = lambda x, i: x.index_select(0, i)
    try:
        want = grad()
    finally:
        scene_mod.gather_rows = saved
    assert inst_mod.gather_rows is gather_rows
    assert got.abs().max() > 0 and torch.equal(got, want)


def _lamp_scene():
    return analytic_cornell(16, 16, sphere_light=True, device="cpu")


def test_self_lit_nee_is_zero_and_gradient_finite():
    """Shading points on the sphere lamp (hit by rays from inside the
    box) draw the lamp: their NEE has ok False and weight 0, while the
    same points moved onto the ceiling keep theirs; and prb_render's
    gradient with respect to the lamp's and the ball's radii is finite,
    the lamp's 0 (its constant radiance and detached samples carry
    none)."""
    scene = _lamp_scene()
    lamp = scene.emitter_shape[0]
    assert lamp >= scene._analytic_base()
    r = np.random.default_rng(0)
    n = 512
    c = scene.scene_analytic.sp_center[1]
    dirs = r.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    target = c.numpy() + 0.12 * dirs
    o = np.tile(np.float32([0.0, 0.2, 0.5]), (n, 1))
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    ray = Ray(o=torch.tensor(o), d=torch.tensor(d, dtype=torch.float32),
              maxt=torch.full((n,), np.inf))
    ctx = scene.trace_ctx()
    active = torch.ones(n, dtype=torch.bool)
    si = scene.ray_intersect(ray, active, ctx)
    on_lamp = si.shape_index == lamp
    assert on_lamp.float().mean() > 0.4
    u1 = torch.rand(n, generator=torch.Generator().manual_seed(2))
    u2 = torch.rand((n, 2), generator=torch.Generator().manual_seed(3))
    ds, weight, ok = scene.sample_emitter_direction(si, u1, u2, on_lamp, ctx)
    assert not ok[on_lamp].any() and not weight[on_lamp].any()
    # the same points on the ceiling's slot draw the lamp as before
    si.shape_index = torch.where(on_lamp, 2, si.shape_index)
    _, w2, ok2 = scene.sample_emitter_direction(si, u1, u2, on_lamp, ctx)
    assert torch.equal(ok2, on_lamp & (ds.pdf > 0)
                       & ~scene.ray_test(si.spawn_ray_to(ds.p), on_lamp
                                         & (ds.pdf > 0), ctx))
    key = "scene_analytic.sp_radius"
    leaf = traverse(scene)[key].clone().requires_grad_()
    img = prb_render(update(scene, {key: leaf}), PRBIntegrator(6, 5), 5, 2,
                     device="cpu")
    torch.sum(img * torch.rand(img.shape, generator=torch.Generator()
                               .manual_seed(4))).backward()
    assert torch.isfinite(leaf.grad).all()
    assert float(leaf.grad[1]) == 0.0 and float(leaf.grad[0]) != 0.0


@pytest.mark.parametrize("rfilter", ["box", "gaussian", "lanczos"])
def test_splat_and_guiding_cpu_bits_are_index_adds(rfilter):
    """On the CPU, ``splat`` (values and filter-weight channel) and the
    guiding grid's ``update`` give what ``index_add`` gave, bit for bit,
    and ``splat`` stays differentiable in the values and positions."""
    g = torch.Generator().manual_seed(5)
    h, w, n = 9, 11, 5000
    pos = torch.rand(n, 2, generator=g) * torch.tensor([w, h]) - 0.5
    val = torch.randn(n, 3, generator=g)
    active = torch.rand(n, generator=g) > 0.1
    rf = getattr(ReconstructionFilter, rfilter)()
    img = splat(pos, val, h, w, rf, active)
    # the same taps summed by index_add, as splat did before
    k = rf.n_taps
    lo = torch.ceil(pos - rf.radius - 0.5).to(torch.int64)
    offs = torch.arange(k)
    xs, ys = lo[:, 0:1] + offs, lo[:, 1:2] + offs
    wx = torch.where((xs >= 0) & (xs < w), rf.eval_1d(xs + 0.5 - pos[:, 0:1]),
                     0.0)
    wy = torch.where((ys >= 0) & (ys < h), rf.eval_1d(ys + 0.5 - pos[:, 1:2]),
                     0.0)
    wt = (wy[:, :, None] * wx[:, None, :]) * active[:, None, None]
    wt = wt / torch.clamp(wt.sum(dim=(1, 2), keepdim=True), min=1e-12)
    data = torch.cat([torch.where(active[:, None], val, 0.0),
                      active[:, None].float()], -1)
    idx = (ys.clamp(0, h - 1)[:, :, None] * w
           + xs.clamp(0, w - 1)[:, None, :]).reshape(-1)
    want = torch.zeros(h * w, 4).index_add(
        0, idx, (wt[..., None] * data[:, None, None, :]).reshape(-1, 4))
    assert torch.equal(img, want.reshape(h, w, 4))
    p, v = pos.clone().requires_grad_(), val.clone().requires_grad_()
    torch.sum(splat(p, v, h, w, rf, active)[..., :3] ** 2).backward()
    assert float(v.grad.abs().sum()) > 0
    if rfilter != "box":   # the box filter's taps are flat in the position
        assert torch.isfinite(p.grad).all() and float(p.grad.abs().sum()) > 0

    lengths = torch.rand(300, generator=g) + 0.1
    eidx = torch.randint(0, 300, (n,), generator=g)
    eidx[: n // 2] = 7
    mass = torch.rand(n, generator=g)
    grid = GridDistr.create(lengths).update(eidx, mass)
    assert torch.equal(grid.mass, torch.zeros(300).index_add(0, eidx, mass))
    base = torch.randn(300, generator=g)
    assert torch.equal(index_add_rows(base, eidx, mass),
                       base.index_add(0, eidx, mass))


def test_fixed_point_sum():
    """The card's scatter-add, run here on the CPU: each row within float32
    rounding of the float64 sum over columns of magnitudes 1e-3 to 1e6,
    the same bits under a permutation of the lanes, NaN in a row that
    received a non-finite value and nowhere else."""
    g = torch.Generator().manual_seed(9)
    idx = torch.randint(0, 64, (50_000,), generator=g)
    v = torch.randn(50_000, 4, generator=g) * torch.tensor(
        [1e-3, 1.0, 1e3, 1e6])
    got = fixed_point_sum(idx, v, 64)
    want = torch.zeros(64, 4, dtype=torch.float64).index_add(0, idx,
                                                              v.double())
    assert torch.allclose(got.double(), want, rtol=1.2e-7, atol=0.0)
    perm = torch.randperm(50_000, generator=g)
    assert torch.equal(fixed_point_sum(idx[perm], v[perm], 64), got)
    v[7, 1] = float("inf")
    bad = fixed_point_sum(idx, v, 64)
    assert torch.isnan(bad[idx[7], 1]) and int(torch.isnan(bad).sum()) == 1
