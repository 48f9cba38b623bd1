"""Helpers for the tests that hold mitsuba_tpu_torch against mitsuba_tpu."""
import numpy as np


def export_scene(scene):
    """The numpy arrays of a JAX Scene, in the layout of
    mitsuba_tpu_torch.convert.scene_from_numpy."""
    from mitsuba_tpu.models.bsdfs import SmoothDiffuse, TwoSided
    from mitsuba_tpu.models.emitters import AreaEmitter, EnvmapEmitter
    from mitsuba_tpu.models.textures import BitmapTexture

    def arr(x):
        return None if x is None else np.asarray(x)

    def texture(t):
        if isinstance(t, BitmapTexture):
            return {"data": arr(t.data),
                    "filter": "nearest" if t.filter_nearest else "bilinear",
                    "wrap": "repeat" if t.wrap_repeat else "clamp"}
        return arr(t.value)

    def bsdf(b):
        if isinstance(b, SmoothDiffuse):
            return {"type": "diffuse", "reflectance": texture(b.reflectance)}
        if isinstance(b, TwoSided):
            return {"type": "twosided", "nested": bsdf(b.nested)}
        out = {"type": b.id}
        for k in ("eta", "k", "alpha"):
            if hasattr(b, k):
                out[k] = arr(getattr(b, k))
        if hasattr(b, "diffuse_reflectance"):   # the plastics
            out["diffuse_reflectance"] = texture(b.diffuse_reflectance)
            out["nonlinear"] = bool(b.nonlinear)
        for k in ("specular_reflectance", "specular_transmittance"):
            if getattr(b, k, None) is not None:
                out[k] = arr(getattr(b, k).value)
        return out

    def emitter(e):
        if isinstance(e, AreaEmitter):
            return {"type": "area", "radiance": arr(e.radiance.value),
                    "sampling_weight": float(e.sampling_weight)}
        if isinstance(e, EnvmapEmitter):   # with its sampling table
            return {"type": "envmap", "data": arr(e.data),
                    "scale": float(e.scale), "to_world": arr(e.to_world),
                    "sampling_weight": float(e.sampling_weight),
                    **{k: arr(getattr(e.distr, k)) for k in (
                        "pdf_table", "row_cdf", "cond_cdf", "row_weight",
                        "total")}}
        return {"type": e.id}

    bsdfs = [bsdf(b) for b in scene.bsdfs]
    emitters = [emitter(e) for e in scene.emitters]
    meshes = [{"vertices": arr(m.vertices), "faces": arr(m.faces),
               "normals": arr(m.normals), "uvs": arr(m.uvs),
               "bsdf_index": m.bsdf_index, "emitter_index": m.emitter_index,
               "id": m.id} for m in scene.meshes]
    s = scene.sensor
    return {"meshes": meshes, "bsdfs": bsdfs, "emitters": emitters,
            "sensor": {"to_world": arr(s.to_world), "fov": s.fov,
                       "fov_axis": s.fov_axis, "near_clip": s.near_clip,
                       "far_clip": s.far_clip, "width": s.film.width,
                       "height": s.film.height, "rfilter": s.film.rfilter.kind,
                       "sample_count": s.sampler.sample_count}}


def jax_scene_with_ball(width, height, subdiv, use_bvh=None):
    """The JAX package's Cornell box plus ``sphere_mesh(subdiv)`` placed
    as in bench.py ``_big_scene`` (smooth normals, white diffuse)."""
    from mitsuba_tpu.core import transform as tf
    from mitsuba_tpu.models.scene import make_scene
    from mitsuba_tpu.models.shapes import Mesh, sphere_mesh
    from mitsuba_tpu.utils.scenes import cornell_box

    base = cornell_box(width=width, height=height)
    v, f, n, uv = sphere_mesh(subdiv, np.asarray(
        tf.compose(tf.translate([0.3, 0.2, 0.2]), tf.scale(0.35))))
    ball = Mesh.make(v, f, normals=n, uvs=uv, bsdf_index=0, id="ball")
    return make_scene(list(base.meshes) + [ball], list(base.bsdfs),
                      list(base.emitters), base.sensor, use_bvh=use_bvh)


def nested_clusters(levels=40, per=25, seed=0):
    """(vertices, faces) of ``levels * per`` small triangles in nested
    clusters inside the Cornell box, each cluster half the size of the
    one around it: the SAH tree over them is deeper than the BVH
    megakernels' walk takes (39 inner nodes with the Cornell box)."""
    r = np.random.default_rng(seed)
    tris = []
    for k in range(levels):
        c = r.normal(size=(per, 3))
        c *= 0.3 * 0.5 ** k / np.linalg.norm(c, axis=1, keepdims=True)
        tris.append(c[:, None] + 0.003 * 0.5 ** k * r.normal(size=(per, 3, 3)))
    v = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    return v, np.arange(len(v)).reshape(-1, 3)


def rounding_tree(device="cpu"):
    """A two-leaf tree built by hand where the two-child walk and the
    miss-link walk can part, and seeded rays that find the case.

    Leaf A (the root's left child, first in DFS order) holds T1 (face 0)
    in the plane z = 1, where A's box starts, and a triangle off the rays'
    path at z = 2; leaf B holds T2 (face 2) in the same plane and a
    triangle off the path at z = 0, so B's box starts nearer.  The rays
    run up +z through both T1 and T2.  The miss-link walk enters A first
    and keeps T1 unless T2 is strictly closer; the two-child walk enters
    B first, and skips A when T2's t lies below A's tnear.  Where T1's t
    rounds below A's tnear and T2's lies between them, the walks return
    different faces.  Returns ``(tree, rows, o, d)``, ``rows`` the (4, 9)
    [p0 | e1 | e2] face rows that ``pack_bvh_geometry`` takes."""
    import torch

    from mitsuba_tpu_torch.ops import bvh

    v = np.array([[-3, -3, 1], [3, -3, 1], [0, 4, 1],
                  [5, 5, 2], [6, 5, 2], [5, 6, 2],
                  [-4, -2, 1], [4, -3, 1], [0.5, 5, 1],
                  [5, 5, 0], [6, 5, 0], [5, 6, 0]], np.float32)
    f = np.arange(12).reshape(4, 3)
    box = [v[f[:2]].reshape(-1, 3), v[f[2:]].reshape(-1, 3)]
    lo = np.stack([v.min(0), box[0].min(0), box[1].min(0)])
    hi = np.stack([v.max(0), box[0].max(0), box[1].max(0)])
    first, count = np.array([0, 0, 2]), np.array([0, 2, 2])
    miss = np.array([-1, 2, -1])
    prims = np.array([0, 1, 2, 3] + [-1] * bvh.LEAF_SIZE)
    pair, depth = bvh.pack_node_pairs(lo, hi, first, count, miss)

    def t(x, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    tree = bvh.BVH(bbox_lo=t(lo, torch.float32), bbox_hi=t(hi, torch.float32),
                   first=t(first), count=t(count), miss=t(miss),
                   prims=t(prims), node_pair=t(pair, torch.float32),
                   depth=depth)
    p = v[f]
    rows = t(np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]],
                            1), torch.float32)
    r = np.random.default_rng(0)
    n = 512
    o = np.concatenate([r.uniform(-0.5, 0.5, (n, 2)),
                        r.uniform(-3.0, -0.5, (n, 1))], 1)
    d = np.concatenate([r.uniform(-0.2, 0.2, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tree, rows, t(o, torch.float32), t(d, torch.float32)
