"""Guarded and resumable optimization loops (mitsuba_tpu/utils/elastic.py).

- ``nan_guard_step``: apply an optimizer step only when every gradient is
  finite; a skipped step leaves the parameters and the optimizer's state
  as they were, and the next step redraws with its own seed.
- ``CheckpointedLoop``: checkpoints (params, optimizer state, step, and
  any extra arrays the loop carries) every ``every`` steps and resumes
  from them; seeds derive from the step index, so a resumed run follows
  the same trajectory.  ``.best`` keeps the lowest-metric state apart.

The JAX package's ``retry_pass`` and ``spp_shard_render`` wait for
ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

import torch

from .checkpoint import load_checkpoint, save_checkpoint
from .logging import Info, Warn, log


def nan_guard_step(opt, params, grads, state):
    """(params, state, ok): ``opt.step`` when every gradient is finite,
    else the inputs unchanged and ok False."""
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        log(Warn, "non-finite gradients: skipping optimizer step")
        return params, state, False
    params, state = opt.step(params, grads, state)
    return params, state, True


class CheckpointedLoop:
    """Resumable optimization loop::

        loop = CheckpointedLoop(path, every=10)
        params, state, start = loop.resume(params, state)
        for it in range(start, iters):
            params, state, _ = nan_guard_step(opt, params, grads, state)
            loop.maybe_save(it, params, state, metric=loss)

    ``extra`` (resume's, restored into ``loop.extra``, and maybe_save's) is
    a dict of arrays the loop carries besides the parameters, such as a
    design's per-sensor drop counts."""

    def __init__(self, path: str, every: int = 10):
        self.path = path
        self.every = int(every)
        self.best = float("inf")
        self.extra = {}

    def resume(self, params, state, extra=None):
        """(params, state, first step): from the checkpoint at ``path``,
        cast to the given trees' dtypes and devices, or the given ones
        and 0 when there is none.  ``extra`` (a dict like the one saved)
        is restored into ``self.extra``."""
        like = {"params": params, "state": state, "step": 0,
                "extra": extra or {}}
        try:
            ck = load_checkpoint(self.path, like)
        except FileNotFoundError:
            return params, state, 0
        self.extra = ck["extra"]
        log(Info, "resumed optimization at step %d from %s", ck["step"] + 1,
            self.path)
        return ck["params"], ck["state"], ck["step"] + 1

    def maybe_save(self, step: int, params, state, metric=None, extra=None):
        """Checkpoint every ``every`` steps; returns whether it saved.
        With ``metric``, the lowest-metric state is also kept at
        ``<path>.best``, so that a run that walks away from its best point
        can be rolled back to it."""
        tree = {"params": params, "state": state, "step": int(step),
                "extra": extra or {}}
        if metric is not None and float(metric) < self.best:
            self.best = float(metric)
            save_checkpoint(self.path + ".best", tree)
        if (step + 1) % self.every == 0:
            save_checkpoint(self.path, tree)
            return True
        return False
