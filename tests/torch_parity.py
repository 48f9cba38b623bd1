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
