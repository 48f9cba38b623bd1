"""Mitsuba XML scene files -> the scene dict -> ``load_dict``
(mitsuba_tpu/utils/xml.py; reference src/core/xml.cpp).

The tag grammar: ``<scene>``, plugin tags with ``<float>``,
``<integer>``, ``<string>``, ``<boolean>``, ``<rgb>``, ``<spectrum>``,
``<point>``, ``<vector>``, ``<transform>`` (``<translate>``,
``<rotate>``, ``<scale>``, ``<lookat>``, ``<matrix>``, composed in
document order, each later tag multiplying on the left) and ``<ref>``
properties; ``$name`` parameters from ``<default>`` tags or the caller,
substituted on word boundaries (``$res`` leaves ``$resx`` alone); the
in-memory upgrade of pre-2.0 files (camelCase names, ``<lookAt>``);
``filename`` strings taken relative to the file's directory.  The
transforms are float32 numpy (``core/transform.py``).  Pure Python and
numpy: nothing here touches a device until ``load_dict``.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from ..core import transform as tf

_PLUGIN_TAGS = {
    "integrator", "sensor", "shape", "bsdf", "emitter", "sampler", "film",
    "rfilter", "texture", "medium", "phase", "spectrum", "volume",
}


def _parse_value(text):
    t = text.strip()
    try:
        if "," in t or " " in t:
            parts = [float(x) for x in t.replace(",", " ").split()]
            return parts if len(parts) > 1 else parts[0]
        return float(t) if ("." in t or "e" in t or "E" in t) else int(t)
    except ValueError:
        return t


def _sub_defaults(text, defaults):
    """``$name`` replaced by its default, longest names first and only
    where no name character follows (xml.cpp substitutes whole names)."""
    if text is None or "$" not in text:
        return text
    for k in sorted(defaults, key=len, reverse=True):
        text = re.sub(rf"\${re.escape(k)}(?![A-Za-z0-9_])",
                      str(defaults[k]), text)
    return text


def _floats(text):
    return [float(x) for x in text.replace(",", " ").split()]


def _parse_transform(node, defaults):
    """A ``<transform>``'s children applied in document order, each later
    one multiplied on the left."""
    m = np.eye(4, dtype=np.float32)
    for child in node:
        tag = child.tag

        def g(name, d=None):
            return _sub_defaults(child.get(name, d), defaults)

        if tag == "translate":
            v = [float(g("x", "0")), float(g("y", "0")), float(g("z", "0"))]
            if child.get("value") is not None:
                v = np.broadcast_to(
                    np.atleast_1d(_parse_value(g("value"))), (3,))
            m = tf.compose(tf.translate(np.asarray(v, np.float32)), m)
        elif tag == "scale":
            if child.get("value") is not None:
                val = _parse_value(g("value"))
                v = val if isinstance(val, list) else [val] * 3
            else:
                v = [float(g("x", "1")), float(g("y", "1")),
                     float(g("z", "1"))]
            m = tf.compose(tf.scale(np.asarray(v, np.float32)), m)
        elif tag == "rotate":
            axis = [float(g("x", "0")), float(g("y", "0")),
                    float(g("z", "0"))]
            m = tf.compose(tf.rotate(np.asarray(axis, np.float32),
                                     float(g("angle", "0"))), m)
        elif tag in ("lookat", "look_at"):
            m = tf.compose(tf.look_at(_floats(g("origin")),
                                      _floats(g("target")),
                                      _floats(g("up", "0 1 0"))), m)
        elif tag == "matrix":
            m = tf.compose(np.asarray(_floats(g("value")),
                                      np.float32).reshape(4, 4), m)
    return np.asarray(m, np.float32)


def _parse_plugin(node, defaults, base_dir):
    """A plugin tag -> {'type': ..., its properties...}."""
    out = {"type": _sub_defaults(node.get("type"), defaults)}
    if node.get("id"):
        out["id"] = node.get("id")
    for child in node:
        tag = child.tag
        name = child.get("name")
        val = _sub_defaults(child.get("value"), defaults)
        if tag == "float":
            out[name] = float(val)
        elif tag == "integer":
            out[name] = int(val)
        elif tag == "boolean":
            out[name] = str(val).lower() == "true"
        elif tag == "string":
            if name == "filename" and base_dir and not os.path.isabs(val):
                val = os.path.join(base_dir, val)
            out[name] = val
        elif tag in ("rgb", "srgb"):
            out[name] = {"type": "rgb", "value": _parse_value(val)}
        elif tag == "spectrum":
            out[name] = {"type": "spectrum", "value": _parse_value(val)}
        elif tag in ("point", "vector"):
            if val is not None:
                out[name] = _parse_value(val)
            else:
                out[name] = [float(_sub_defaults(child.get(a, "0"), defaults))
                             for a in ("x", "y", "z")]
        elif tag == "transform":
            out[name] = _parse_transform(child, defaults)
        elif tag == "ref":
            out[name or "bsdf"] = {"type": "ref", "id": child.get("id")}
        elif tag in _PLUGIN_TAGS:
            out[name or tag] = _parse_plugin(child, defaults, base_dir)
    return out


def _camel_to_underscore(name):
    out = []
    i = 0
    while i < len(name):
        c = name[i]
        if i + 1 < len(name) and c.islower() and name[i + 1].isupper():
            out.append(c)
            out.append("_")
            i += 1
            while i < len(name) and name[i].isupper():
                out.append(name[i].lower())
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def upgrade_tree(root, version):
    """The in-memory migration of a pre-2.0 scene file (xml.cpp:302
    upgrade_tree): camelCase names become underscore_case, ``<lookAt>``
    becomes ``<lookat>``, reserved '_'-prefixed ids are renamed, a
    diffuse BSDF's 'diffuse_reflectance' becomes 'reflectance', and the
    uoffset / voffset / uscale / vscale floats fold into a 'to_uv'
    transform."""
    try:
        major = int(str(version).split(".")[0])
    except (ValueError, AttributeError):
        return root
    if major >= 2:
        return root
    for node in root.iter():
        if node.tag == "lookAt":
            node.tag = "lookat"
        if node.tag != "default" and node.get("name"):
            node.set("name", _camel_to_underscore(node.get("name")))
        if node.get("id", "").startswith("_"):
            node.set("id", "ID" + node.get("id") + "__UPGR")
    for bsdf in root.iter("bsdf"):
        if bsdf.get("type") == "diffuse":
            for ch in bsdf:
                if ch.get("name") == "diffuse_reflectance":
                    ch.set("name", "reflectance")
    for node in root.iter():
        legacy = {ch.get("name"): ch for ch in list(node)
                  if ch.tag == "float" and ch.get("name") in
                  ("uoffset", "voffset", "uscale", "vscale")}
        if not legacy:
            continue
        off = [float(legacy[k].get("value", 0.0)) if k in legacy else 0.0
               for k in ("uoffset", "voffset")]
        scl = [float(legacy[k].get("value", 1.0)) if k in legacy else 1.0
               for k in ("uscale", "vscale")]
        for ch in legacy.values():
            node.remove(ch)
        trafo = ET.SubElement(node, "transform", {"name": "to_uv"})
        if off != [0.0, 0.0]:
            ET.SubElement(trafo, "translate",
                          {"x": str(off[0]), "y": str(off[1])})
        if scl != [1.0, 1.0]:
            ET.SubElement(trafo, "scale", {"x": str(scl[0]), "y": str(scl[1])})
    return root


def xml_to_dict(path_or_string, defaults=None):
    """A scene file (or its text) -> the dict ``load_dict`` takes: each
    top-level plugin under its id, or its tag (``shape``, ``shape_2``,
    ...) without one.  ``defaults`` take precedence over the file's
    ``<default>`` tags."""
    defaults = dict(defaults or {})
    if os.path.exists(str(path_or_string)):
        root = ET.parse(path_or_string).getroot()
        base_dir = os.path.dirname(os.path.abspath(path_or_string))
    else:
        root = ET.fromstring(path_or_string)
        base_dir = os.getcwd()
    if root.tag != "scene":
        raise ValueError(f"expected <scene>, got <{root.tag}>")
    root = upgrade_tree(root, root.get("version", "3.0.0"))
    for child in root:
        if child.tag == "default":
            defaults.setdefault(child.get("name"), child.get("value"))
    scene = {"type": "scene"}
    counters = {}
    for child in root:
        if child.tag not in _PLUGIN_TAGS:
            continue
        key = child.get("id")
        if not key:
            counters[child.tag] = counters.get(child.tag, 0) + 1
            key = (child.tag if counters[child.tag] == 1
                   else f"{child.tag}_{counters[child.tag]}")
        scene[key] = _parse_plugin(child, defaults, base_dir)
    return scene


def load_file(path, defaults=None, device=None, **kw):
    """A scene file -> Scene on ``device`` (default: the GPU), the
    ``mi.load_file`` analogue: keyword arguments override the file's
    ``<default>`` parameters (``load_file(path, spp=16)``)."""
    from .load import load_dict

    defaults = dict(defaults or {})
    defaults.update({k: str(v) for k, v in kw.items()})
    return load_dict(xml_to_dict(path, defaults), device=device)
