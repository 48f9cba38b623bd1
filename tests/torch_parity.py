"""Helpers for the tests that hold mitsuba_tpu_torch against mitsuba_tpu."""
import numpy as np


def export_scene(scene):
    """The numpy arrays of a JAX Scene, in the layout of
    mitsuba_tpu_torch.convert.scene_from_numpy."""
    from mitsuba_tpu.models.bsdfs import SmoothDiffuse
    from mitsuba_tpu.models.emitters import AreaEmitter

    def arr(x):
        return None if x is None else np.asarray(x)

    bsdfs = [({"type": "diffuse", "reflectance": arr(b.reflectance.value)}
              if isinstance(b, SmoothDiffuse) else {"type": b.id})
             for b in scene.bsdfs]
    emitters = [({"type": "area", "radiance": arr(e.radiance.value),
                  "sampling_weight": float(e.sampling_weight)}
                 if isinstance(e, AreaEmitter) else {"type": e.id})
                for e in scene.emitters]
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
