"""What refitting the BVH on every render costs: this checkout against an
earlier one, in turns, on one GPU.

    python -m mitsuba_tpu_torch.utils.refit_cost --other DIR [--out FILE]

``DIR`` is the root of an earlier checkout (for example a ``git archive``
of the parent commit unpacked into the ignored ``_tree/``), one whose
scene packs the built tree's boxes without a refit.  Each turn is a
process of its own that imports the package of one checkout (this file
is run in it with ``runpy``, so it imports only that checkout's
package); the turns go other, this, this, other, so each tree gets an
early and a late turn on the card.

A turn measures, on ``big_scene(256, 256)`` (81,956 triangles, the
at-scale cell) left as built, seed 7, max_depth 6, rr_depth 5:

- ``trace_ctx``: ``Scene.trace_ctx`` (the wavefront's and PRB's packing,
  the refit included where there is one), CUDA-event median of 9;
- ``pack_scene_bvh``: the BVH megakernels' packing, likewise;
- ``refit_bvh``: the refit alone, where the checkout has one;
- ``render_path``: ``render`` with the ``PathIntegrator``, 16 spp, and
  ``render_mega``: with the ``MegakernelPathIntegrator``, 16 spp;
  host-clock medians of 5 synchronised renders, after one warm-up;
- ``prb_step``: one PRB step (``prb_render`` at 16 / 16 spp, the mean
  as loss, backward) with respect to the white albedo and the ball's
  vertices, host-clock median of 3 after a warm-up, and the
  ``trace_ctx`` calls (so refits) a step makes;
- where the checkout has the lens path: the ``trace_ctx`` calls of one
  loss gradient of the triplet EFL design (the example's full size,
  three sensors) and ``refit_bvh`` on its 1,730-face tree;
- ``peak_gib``: the card's peak memory of the big_scene measurements.

Prints one JSON line a turn and, last, one JSON object with every turn;
``--out`` writes that object to a file too.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from contextlib import contextmanager

SEED = 7
SPP = 16


@contextmanager
def _count_calls(owner, name):
    """Within the block each call of ``owner.<name>`` adds one to the
    yielded list's only entry."""
    n = [0]
    fn = getattr(owner, name)

    def counted(*args, **kw):
        n[0] += 1
        return fn(*args, **kw)

    setattr(owner, name, counted)
    try:
        yield n
    finally:
        setattr(owner, name, fn)


def measure():
    """One turn in the checkout whose package ``sys.path`` finds; returns
    the turn's numbers."""
    import torch

    from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                                   PRBIntegrator, big_scene, prb_render,
                                   render)
    from mitsuba_tpu_torch.models.scene import Scene
    from mitsuba_tpu_torch.ops import bvh
    from mitsuba_tpu_torch.ops.megakernel_bvh import pack_scene_bvh
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.profile_path import events_ms, wall_ms

    out = {}
    scene = big_scene(256, 256)
    out["trace_ctx_ms"] = events_ms(scene.trace_ctx, 9)
    out["pack_scene_bvh_ms"] = events_ms(lambda: pack_scene_bvh(scene), 9)
    if hasattr(bvh, "refit_bvh"):
        v = scene.geometry()[0]
        out["refit_bvh_ms"] = events_ms(
            lambda: bvh.refit_bvh(scene.accel, v), 9)
    for key, integ in (
            ("render_path_ms", PathIntegrator(max_depth=6, rr_depth=5)),
            ("render_mega_ms", MegakernelPathIntegrator(max_depth=6,
                                                        rr_depth=5))):
        render(scene, integ, SEED, SPP)
        out[key] = wall_ms(lambda: render(scene, integ, SEED, SPP), 5)

    integ = PRBIntegrator(max_depth=6, rr_depth=5)
    leaves = traverse(scene)
    params = {k: leaves[k] for k in ("bsdfs.0.reflectance.value",
                                     "meshes.8.vertices")}

    def step():
        p = {k: v.detach().clone().requires_grad_() for k, v in
             params.items()}
        img = prb_render(update(scene, p), integ, SEED, SPP, SPP,
                         device=scene.device)
        torch.mean(img).backward()

    step()
    out["prb_step_ms"] = wall_ms(step, 3)
    with _count_calls(Scene, "trace_ctx") as calls:
        step()
    out["prb_step_trace_ctx_calls"] = calls[0]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    if importlib.util.find_spec("mitsuba_tpu_torch.lens") is not None:
        from mitsuba_tpu_torch.examples.triplet_efl_design import (
            build_triplet, make_problem)
        from mitsuba_tpu_torch.lens.design import value_and_grad

        dp = make_problem(build_triplet())
        with _count_calls(Scene, "trace_ctx") as calls:
            value_and_grad(dp.loss)(dp.params(), 0)
        out["triplet_loss_grad_trace_ctx_calls"] = calls[0]
        sc = dp.base_scene
        v, f = sc.geometry()[:2]
        out["triplet_faces"] = int(f.shape[0])
        out["triplet_refit_bvh_ms"] = events_ms(
            lambda: bvh.refit_bvh(sc.accel, v), 9)
    return out


def _turn(root):
    """Run one turn in a process of its own with the package of the
    checkout at ``root``; returns its numbers."""
    code = ("import json, runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "m = runpy.run_path(sys.argv[2]); "
            "print('TURN ' + json.dumps(m['measure']()))")
    res = subprocess.run([sys.executable, "-c", code, root,
                          os.path.abspath(__file__)],
                         cwd=root, capture_output=True, text=True,
                         check=False)
    if res.returncode != 0:
        sys.stderr.write(res.stdout + res.stderr)
        raise RuntimeError(f"the turn in {root} failed "
                           f"(exit {res.returncode})")
    line = [x for x in res.stdout.splitlines() if x.startswith("TURN ")][-1]
    return json.loads(line[len("TURN "):])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the earlier checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(args.other)
    turns = []
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        t = dict(tree=name, **_turn(root))
        print(json.dumps(t), flush=True)
        turns.append(t)
    result = {"turns": turns}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
