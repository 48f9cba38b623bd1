"""Scene parameters: the ``mi.traverse()`` / ``SceneParameters`` analogue
(mitsuba_tpu/utils/params.py; reference src/python/python/util.py:13-292).

The port's Scene is a tree of dataclasses (meshes, BSDFs, textures,
emitters, sensor), so a parameter view is a dict of dotted path ->
tensor, with the JAX package's path strings: ``bsdfs.0.reflectance.value``,
``bsdfs.3.reflectance.data``, ``emitters.0.radiance.value``,
``meshes.6.vertices``, ``sensor.to_world``, ``scene_sdf.values``,
``instances.0.to_world``, ``instances.0.vertices``,
``scene_analytic.cv_cp``.  A JAX ``traverse(scene)`` dict taken to numpy
applies to the port's scene unchanged.

``update`` rebuilds the scene with ``dataclasses.replace`` around the
new leaves.  The detached precomputations are not parameters and are
kept as they are: the area lights' face distributions
(``face_distrs``), the emitter selection (``emitter_distr``), the BVH
(``accel``, a group's tree too) and the environment map's sampling
table (``distr``).  An instanced group's ``to_object`` and world boxes
are not parameters either: the group derives them from ``to_world`` and
its vertices whenever ``update`` rebuilds it, so an update of
``instances.<i>.to_world`` moves the boxes that the candidate rounds
test (the JAX package keeps those of the group's creation).  The
BVH's topology is kept, and its boxes are refitted to the current
vertices at every render (``Scene.trace_ctx``, ``pack_scene_bvh``), so
moved vertices never walk stale boxes; ``refresh_accel`` rebuilds the
tree, which only a change of topology (faces added or removed) needs.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

# fields that hold detached precomputations, never parameters
DETACHED = frozenset({"face_distrs", "emitter_distr", "accel", "distr",
                      "to_object", "world_lo", "world_hi"})


def _children(obj):
    """(name, child) of a dataclass's fields or a sequence's items."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in DETACHED]
    if isinstance(obj, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(obj)]
    return []


def _join(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def traverse(scene, include=None):
    """Flatten ``scene`` into {path: tensor}, every tensor leaf in field
    order.  ``include``: an optional regex; only matching paths are
    returned (the reference workflow's ``params.keep(...)``)."""
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, torch.Tensor):
            if include is None or re.search(include, prefix):
                out[prefix] = obj
            return
        for name, child in _children(obj):
            walk(child, _join(prefix, name))

    walk(scene, "")
    return out


def float_leaves(scene):
    """The floating-point leaves of ``traverse``: what a gradient can
    reach (the JAX package's ``_float_partition``)."""
    return {k: v for k, v in traverse(scene).items() if v.is_floating_point()}


def _as_leaf(value, leaf, path):
    """``value`` as a tensor of ``leaf``'s dtype on its device: a tensor
    keeps its autograd history; an array is copied."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.array(value))
    value = value.to(device=leaf.device, dtype=leaf.dtype)
    if value.shape != leaf.shape:
        raise ValueError(f"{path}: shape {tuple(value.shape)} does not match "
                         f"the scene's {tuple(leaf.shape)}")
    return value


def update(scene, params: dict):
    """A new scene with the {path: value} leaves substituted; paths the
    scene does not have (a JAX dict's ``face_distrs.0.pmf``, say) are
    ignored, as in the JAX package.  Unchanged subtrees are shared."""
    prefixes = {""}
    for path in params:
        parts = path.split(".")
        prefixes.update(".".join(parts[:i]) for i in range(1, len(parts)))

    def rebuild(obj, prefix):
        if isinstance(obj, torch.Tensor):
            return (_as_leaf(params[prefix], obj, prefix) if prefix in params
                    else obj)
        if prefix not in prefixes:
            return obj
        changed = {}
        for name, child in _children(obj):
            new = rebuild(child, _join(prefix, name))
            if new is not child:
                changed[name] = new
        if not changed:
            return obj
        if isinstance(obj, (tuple, list)):
            return type(obj)(changed.get(str(i), x) for i, x in enumerate(obj))
        return dataclasses.replace(obj, **changed)

    return rebuild(scene, "")


def refresh_accel(scene):
    """Rebuild the host-side BVH (Scene::parameters_changed,
    scene.cpp:481-509) after a change of topology; moved vertices need no
    rebuild, since every render refits the tree's boxes.  A scene without
    a BVH comes back as it is."""
    if scene.accel is None:
        return scene
    from ..ops.bvh import build_bvh

    v, f = scene.geometry()[:2]
    return dataclasses.replace(scene, accel=build_bvh(
        v.detach().cpu().numpy(), f.cpu().numpy(), device=scene.device))


class SceneParameters(dict):
    """Dict view bound to a scene; ``apply()`` returns the updated scene
    (the reference's SceneParameters update flow, util.py:148-185, in
    functional form)."""

    def __init__(self, scene, include=None):
        super().__init__(traverse(scene, include))
        self._scene = scene

    def keep(self, pattern):
        for k in [k for k in self if not re.search(pattern, k)]:
            del self[k]
        return self

    def apply(self, rebuild_accel: bool = False):
        scene = update(self._scene, dict(self))
        return refresh_accel(scene) if rebuild_accel else scene
