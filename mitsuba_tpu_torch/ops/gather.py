"""Row gathers whose backward adds in a fixed order.

``x.index_select(0, index)`` differentiates into an ``index_add_`` over
the rows of ``x``.  On a CUDA tensor that scatter is made of atomic
adds, whose order, and so whose float32 rounding, changes from run to
run: PRB's adjoint parted by about 1e-12 between two runs of one step on
the card (ROADMAP.md Queue 3 item 5).  ``gather_rows`` gathers the same
rows, and its backward sums the gradient rows of each source row in a
fixed order:

- on a CPU tensor by ``index_add_``, which adds the lanes one after the
  other in lane order: the bits of ``index_select``'s own backward;
- on a CUDA tensor by ``segment_sum``: the lanes are sorted by row once
  (a stable sort), then each row's run is summed in blocks of
  ``SEGMENT_BLOCK`` consecutive lanes, block sums again in blocks, until
  one sum is left a row.  Every step is a sort, a gather, an
  ``index_copy_`` to distinct rows or a ``sum`` over a fixed axis, so
  the bits repeat from run to run.

Forward-mode AD (``prb_render_forward``) gathers the tangent's rows.

``index_add_rows`` is a forward scatter-add whose sums repeat (the
particle tracer's ``film.splat``, the guiding grid's
``GridDistr.update``): ``index_add`` on a CPU tensor; on a CUDA tensor a
fixed-point sum, each column's values scaled by a power of two (2^62
over the column's sum of magnitudes), rounded to int64 and added by
``index_add_``, whose integer atomics give the same sum in any order;
the sums come back divided by the scale.  Each term rounds at 2^-62 of
its column's magnitude, so the result is nearer the exact sum than a
float32 scatter.  It is about 25 times cheaper than ``segment_sum`` on
a splat's millions of taps (``utils/compare_designs.py --phases
splat``).
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwad

SEGMENT_BLOCK = 8   # lanes summed together at each level of segment_sum


def segment_sum(index, values, n_rows: int):
    """(n_rows, ...) sums of the rows of ``values`` (N, ...) that
    ``index`` (N,) int64 sends to each row, in an order fixed by the
    inputs alone: the lanes sorted stably by row, each row's run summed
    ``SEGMENT_BLOCK`` lanes at a time (zero-padded), level after level,
    until one value is left.  Rows no lane names are 0."""
    tail = values.shape[1:]
    flat = values.reshape(values.shape[0], -1)
    out = flat.new_zeros((n_rows, flat.shape[1]))
    if index.numel() == 0:
        return out.reshape((n_rows,) + tail)
    seg, order = torch.sort(index, stable=True)
    vals = flat.index_select(0, order)
    b = SEGMENT_BLOCK
    while seg.numel():
        n = seg.shape[0]
        new = torch.ones(n, dtype=torch.bool, device=seg.device)
        new[1:] = seg[1:] != seg[:-1]
        starts = torch.nonzero(new).squeeze(1)
        lengths = torch.diff(starts, append=starts.new_tensor([n]))
        done = lengths == 1
        first = starts[done]
        out.index_copy_(0, seg[first], vals.index_select(0, first))
        if bool(done.all()):
            break
        run = torch.cumsum(new, 0) - 1        # each lane's run
        live = ~done[run]                      # lanes of runs still > 1
        run_live = run[live]
        rank = (torch.arange(n, device=seg.device) - starts[run])[live]
        blocks = torch.where(done, 0, (lengths + b - 1) // b)
        base = torch.cumsum(blocks, 0) - blocks
        slot = (base[run_live] + rank // b) * b + rank % b
        total = int(blocks.sum())
        padded = vals.new_zeros((total * b, vals.shape[1]))
        padded.index_copy_(0, slot, vals[live])
        vals = padded.view(total, b, -1).sum(dim=1)
        seg = torch.repeat_interleave(seg[starts], blocks)
    return out.reshape((n_rows,) + tail)


FIXED_POINT_BITS = 62   # a column's sum of magnitudes, in int64 units


def fixed_point_sum(index, values, n_rows: int):
    """(n_rows, ...) sums of the rows of ``values`` (N, ...) that
    ``index`` (N,) int64 sends to each row, the same bits in any order of
    addition: each column scaled by 2^(FIXED_POINT_BITS - ceil(log2 of
    its sum of magnitudes)), rounded to int64, scattered by integer
    ``index_add_`` and divided back, in float64.  A row that receives a
    non-finite value is NaN."""
    tail = values.shape[1:]
    flat = values.reshape(values.shape[0], -1).to(torch.float64)
    finite = torch.isfinite(flat)
    flat = torch.where(finite, flat, 0.0)
    mag = torch.clamp(flat.abs().sum(dim=0), min=1e-300)
    scale = torch.exp2(FIXED_POINT_BITS - torch.ceil(torch.log2(mag)))
    q = torch.round(flat * scale).to(torch.int64)
    acc = q.new_zeros((n_rows, flat.shape[1])).index_add_(0, index, q)
    bad = torch.zeros((n_rows, flat.shape[1]), dtype=torch.int32,
                      device=flat.device).index_add_(
        0, index, (~finite).to(torch.int32))
    out = torch.where(bad > 0, float("nan"), acc.to(torch.float64) / scale)
    return out.to(values.dtype).reshape((n_rows,) + tail)


class _IndexAddRows(torch.autograd.Function):
    """``base`` plus ``fixed_point_sum``; the backward gathers, as
    ``index_add``'s does."""

    @staticmethod
    def forward(ctx, base, index, values):
        ctx.save_for_backward(index)
        return base + fixed_point_sum(index, values.to(base.dtype),
                                      base.shape[0])

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return grad, None, grad.index_select(0, index)


def index_add_rows(base, index, values):
    """``base.index_add(0, index, values)`` (``index`` int64), its sums the
    same from run to run: on a CPU tensor ``index_add`` itself, which adds
    the lanes onto ``base`` one after the other; on a CUDA tensor ``base``
    plus ``fixed_point_sum`` of the lanes, where a float ``index_add`` is
    made of atomic adds whose order, and so whose rounding, changes from
    run to run.  Differentiable with respect to ``base`` and ``values``
    on both."""
    if base.device.type == "cpu":
        return base.index_add(0, index, values)
    return _IndexAddRows.apply(base, index, values)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(x, index):
        return x.index_select(0, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, index = inputs
        ctx.n_rows = x.shape[0]
        ctx.save_for_backward(index)
        ctx.save_for_forward(index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        if grad.device.type == "cpu":
            g = grad.new_zeros((ctx.n_rows,) + grad.shape[1:])
            return g.index_add_(0, index, grad), None
        return segment_sum(index, grad, ctx.n_rows), None

    @staticmethod
    def jvp(ctx, x_t, _):
        (index,) = ctx.saved_tensors
        return x_t.index_select(0, index)


def gather_rows(x, index):
    """``x.index_select(0, index)`` (``index`` int64), whose gradient
    with respect to ``x`` sums each row's lanes in a fixed order (the
    module docstring); a tensor that needs no gradient is gathered
    plainly."""
    if not (x.requires_grad or fwad.unpack_dual(x).tangent is not None):
        return x.index_select(0, index)
    return _GatherRows.apply(x, index)
