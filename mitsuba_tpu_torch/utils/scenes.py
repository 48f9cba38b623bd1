"""Canonical test scenes (mitsuba_tpu/utils/scenes.py).

``cornell_box()`` reproduces the reference's scene dictionary
(src/python/python/util.py:565 ``mi.cornell_box()``): the same wall
albedos, light radiance, camera pose and fov, and box placement, built
as triangle meshes.  ``big_scene()`` is the JAX package's at-scale
workload (``bench._big_scene``): the Cornell box plus a smooth-shaded
icosphere, 81,956 triangles at the default subdivision.
"""
from __future__ import annotations

import torch

from ..core import transform as tf
from ..device import resolve_device
from ..models.bsdfs import SmoothDiffuse
from ..models.emitters import AreaEmitter
from ..models.film import Film, ReconstructionFilter
from ..models.scene import make_scene
from ..models.sensors import PerspectiveCamera
from ..models.shapes import Mesh, cube, rectangle, sphere_mesh
from ..models.textures import ConstantTexture


def cornell_box(width: int = 256, height: int = 256, rfilter=None,
                small_box_bsdf: int | None = None,
                large_box_bsdf: int | None = None, device=None):
    """Cornell box Scene (reference util.py:565 parameters) on ``device``
    (default: the GPU; pass ``device="cpu"`` for the CPU).

    ``small_box_bsdf`` / ``large_box_bsdf`` override the boxes' BSDF
    index, as in the JAX package; a caller that points them past the
    three walls' BSDFs rebuilds the scene with its own BSDFs appended
    (``make_scene(scene.meshes, scene.bsdfs + extra, ...)``)."""
    device = resolve_device(device)
    T = tf.compose

    def rgb(v):
        return ConstantTexture(torch.tensor(v, dtype=torch.float32,
                                            device=device))

    bsdfs = [SmoothDiffuse(rgb([0.885809, 0.698859, 0.666422])),   # white
             SmoothDiffuse(rgb([0.105421, 0.37798, 0.076425])),    # green
             SmoothDiffuse(rgb([0.570068, 0.0430135, 0.0443706]))]  # red
    W, G, R = 0, 1, 2
    small_box_bsdf = W if small_box_bsdf is None else small_box_bsdf
    large_box_bsdf = W if large_box_bsdf is None else large_box_bsdf
    light_emitter = AreaEmitter(radiance=rgb([18.387, 13.9873, 6.75357]))

    def mesh(gen, to_world, bsdf, emitter=-1, id=""):
        v, f, _n, uv = gen(to_world)
        # flat shading for the box geometry: no vertex normals
        return Mesh.make(v, f, normals=None, uvs=uv, bsdf_index=bsdf,
                         emitter_index=emitter, id=id, device=device)

    meshes = [
        mesh(rectangle,
             T(tf.translate([0.0, 0.99, 0.01]), tf.rotate([1, 0, 0], 90),
               tf.scale([0.23, 0.19, 0.19])),
             W, emitter=0, id="light"),
        mesh(rectangle,
             T(tf.translate([0.0, -1.0, 0.0]), tf.rotate([1, 0, 0], -90)),
             W, id="floor"),
        mesh(rectangle,
             T(tf.translate([0.0, 1.0, 0.0]), tf.rotate([1, 0, 0], 90)),
             W, id="ceiling"),
        mesh(rectangle, T(tf.translate([0.0, 0.0, -1.0])), W, id="back"),
        mesh(rectangle,
             T(tf.translate([1.0, 0.0, 0.0]), tf.rotate([0, 1, 0], -90)),
             G, id="green-wall"),
        mesh(rectangle,
             T(tf.translate([-1.0, 0.0, 0.0]), tf.rotate([0, 1, 0], 90)),
             R, id="red-wall"),
        mesh(cube,
             T(tf.translate([0.335, -0.7, 0.38]), tf.rotate([0, 1, 0], -17),
               tf.scale(0.3)),
             small_box_bsdf, id="small-box"),
        mesh(cube,
             T(tf.translate([-0.33, -0.4, -0.28]), tf.rotate([0, 1, 0], 18.25),
               tf.scale([0.3, 0.61, 0.3])),
             large_box_bsdf, id="large-box"),
    ]

    film = Film(width=width, height=height,
                rfilter=rfilter or ReconstructionFilter.gaussian())
    sensor = PerspectiveCamera(
        to_world=torch.as_tensor(
            tf.look_at([0, 0, 3.90], [0, 0, 0], [0, 1, 0]), device=device),
        film=film,
        fov=39.3077,
        fov_axis="smaller",
        near_clip=0.001,
        far_clip=100.0,
    )
    return make_scene(meshes, bsdfs, [light_emitter], sensor, device)


def big_scene(width: int = 256, height: int = 256, subdiv: int = 6,
              device=None):
    """Cornell box + a white diffuse icosphere of ``sphere_mesh(subdiv)``
    with smooth normals (bench.py ``_big_scene``): 36 + 20 * 4**subdiv
    triangles, so above MAX_FACES it carries a host-built BVH."""
    device = resolve_device(device)
    base = cornell_box(width, height, device=device)
    v, f, n, uv = sphere_mesh(subdiv, tf.compose(tf.translate([0.3, 0.2, 0.2]),
                                                 tf.scale(0.35)))
    ball = Mesh.make(v, f, normals=n, uvs=uv, bsdf_index=0, id="ball",
                     device=device)
    return make_scene(list(base.meshes) + [ball], list(base.bsdfs),
                      list(base.emitters), base.sensor, device)
