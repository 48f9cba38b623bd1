"""Canonical test scenes (mitsuba_tpu/utils/scenes.py).

``cornell_box()`` reproduces the reference's scene dictionary
(src/python/python/util.py:565 ``mi.cornell_box()``): the same wall
albedos, light radiance, camera pose and fov, and box placement, built
as triangle meshes.  ``big_scene()`` is the JAX package's at-scale
workload (``bench._big_scene``): the Cornell box plus a smooth-shaded
icosphere, 81,956 triangles at the default subdivision.

The surface scenes put plastic, two-sided and bitmap-textured BSDFs on
them, with the parameters of the JAX package's own cases
(tests/test_megakernel.py ``test_plastic_matches_wavefront`` and
``test_twosided_matches_wavefront``): ``plastic_cornell``,
``twosided_cornell``, ``textured_cornell`` and ``surfaces_big_scene``.

The environment-map scenes take the geometry of the JAX package's own
envmap case (tests/test_megakernel.py ``_env_scene``: a floor, a ball and
an optional small area light) under ``sky_envmap``, a 2048 x 1024 sky
with a sun made from a seed: ``envmap_scene`` and ``envmap_big_scene``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transform as tf
from ..device import resolve_device
from ..models.bsdfs import (CONDUCTOR_IOR, RoughConductor, RoughPlastic,
                            SmoothConductor, SmoothDiffuse, SmoothPlastic,
                            TwoSided)
from ..models.emitters import AreaEmitter, EnvmapEmitter
from ..models.film import Film, ReconstructionFilter
from ..models.scene import make_scene
from ..models.sensors import PerspectiveCamera
from ..models.shapes import Mesh, cube, rectangle, sphere_mesh
from ..models.textures import BitmapTexture, ConstantTexture


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


def _with_bsdfs(base, assign, meshes=None):
    """``base`` with BSDFs appended and meshes re-pointed at them:
    ``assign`` maps a mesh index to its new BSDF."""
    bsdfs = list(base.bsdfs)
    meshes = list(meshes or base.meshes)
    for mesh, bsdf in assign.items():
        meshes[mesh] = dataclasses.replace(meshes[mesh],
                                           bsdf_index=len(bsdfs))
        bsdfs.append(bsdf)
    return make_scene(meshes, bsdfs, base.emitters, base.sensor, base.device)


def _rgb(v, device):
    return ConstantTexture(torch.tensor(v, dtype=torch.float32,
                                        device=device))


def _reversed(mesh):
    """``mesh`` with its faces' winding reversed: flat shading then sees
    its back faces from outside."""
    return dataclasses.replace(mesh, faces=mesh.faces.flip(1).contiguous())


def checker_bitmap(height: int, width: int, channels: int, seed: int,
                   cells: int = 8):
    """A (height, width, channels) float32 numpy image made from ``seed``:
    a checker of ``cells`` x ``cells`` squares, tinted per channel, plus
    uniform noise, clipped to [0.1, 0.9]."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    check = ((yy * cells // height + xx * cells // width) % 2)
    tint = r.uniform(0.6, 1.0, channels)
    img = (0.25 + 0.5 * check)[..., None] * tint \
        + r.uniform(-0.15, 0.15, (height, width, channels))
    return np.clip(img, 0.1, 0.9).astype(np.float32)


def plastic_cornell(width: int = 256, height: int = 256, device=None):
    """The Cornell box with the small box a SmoothPlastic ([0.6, 0.2,
    0.3], eta 1.49, nonlinear) and the large box a RoughPlastic ([0.2,
    0.5, 0.7], eta 1.6, alpha 0.3)."""
    base = cornell_box(width, height, device=device)
    dev = base.device
    return _with_bsdfs(base, {
        6: SmoothPlastic(_rgb([0.6, 0.2, 0.3], dev),
                         torch.tensor(1.49, device=dev), nonlinear=True),
        7: RoughPlastic(_rgb([0.2, 0.5, 0.7], dev),
                        torch.tensor(1.6, device=dev),
                        torch.tensor(0.3, device=dev))})


def twosided_cornell(width: int = 256, height: int = 256, device=None):
    """The Cornell box with both boxes' winding reversed, so the camera
    and the light see their back faces: the small box a
    TwoSided(SmoothDiffuse([0.7, 0.3, 0.2])), the large box a
    TwoSided(RoughConductor(eta [0.2, 0.92, 1.1], k [3.9, 2.45, 2.14],
    alpha 0.25))."""
    base = cornell_box(width, height, device=device)
    dev = base.device
    meshes = list(base.meshes)
    meshes[6], meshes[7] = _reversed(meshes[6]), _reversed(meshes[7])
    return _with_bsdfs(base, {
        6: TwoSided(SmoothDiffuse(_rgb([0.7, 0.3, 0.2], dev))),
        7: TwoSided(RoughConductor(
            eta=torch.tensor([0.2, 0.92, 1.1], device=dev),
            k=torch.tensor([3.9, 2.45, 2.14], device=dev),
            alpha=torch.tensor(0.25, device=dev)))}, meshes)


def textured_cornell(width: int = 256, height: int = 256, seed: int = 7,
                     device=None):
    """The Cornell box with two bitmap textures made from ``seed``
    (``checker_bitmap``): the back wall a 512 x 512 x 3 bilinear bitmap
    whose uvs are scaled by 3, so that wrapping tiles it 3 x 3, and the
    small box a 256 x 256 x 1 nearest bitmap that clamps, its uvs
    stretched to [-0.25, 1.25] so that the clamp shows."""
    base = cornell_box(width, height, device=device)
    dev = base.device
    meshes = list(base.meshes)
    meshes[3] = dataclasses.replace(meshes[3], uvs=meshes[3].uvs * 3.0)
    meshes[6] = dataclasses.replace(meshes[6],
                                    uvs=meshes[6].uvs * 1.5 - 0.25)

    def bitmap(size, channels, nearest, seed_k):
        return SmoothDiffuse(BitmapTexture(
            data=torch.tensor(checker_bitmap(size, size, channels, seed_k),
                              device=dev),
            filter_nearest=nearest, wrap_repeat=not nearest))

    return _with_bsdfs(base, {3: bitmap(512, 3, False, seed),
                              6: bitmap(256, 1, True, seed + 1)}, meshes)


def surfaces_big_scene(width: int = 256, height: int = 256, subdiv: int = 6,
                       textured: bool = False, seed: int = 7, device=None):
    """big_scene's meshes with the ball a RoughPlastic ([0.2, 0.5, 0.7],
    eta 1.6, alpha 0.3) and the small box a TwoSided(SmoothConductor) of
    Cu; ``textured`` makes the ball a diffuse under a 512 x 512 x 3
    bilinear bitmap made from ``seed`` on its spherical uvs instead."""
    base = big_scene(width, height, subdiv, device=device)
    dev = base.device
    if textured:
        ball = SmoothDiffuse(BitmapTexture(
            data=torch.tensor(checker_bitmap(512, 512, 3, seed),
                              device=dev)))
    else:
        ball = RoughPlastic(_rgb([0.2, 0.5, 0.7], dev),
                            torch.tensor(1.6, device=dev),
                            torch.tensor(0.3, device=dev))
    eta, k = (torch.tensor(x, device=dev) for x in CONDUCTOR_IOR["Cu"])
    return _with_bsdfs(base, {len(base.meshes) - 1: ball,
                              6: TwoSided(SmoothConductor(eta=eta, k=k))})


def sky_envmap(height: int = 1024, width: int = 2048, seed: int = 7):
    """An (height, width, 3) float32 lat-long sky made from ``seed`` (row 0
    the zenith): a blue gradient that brightens toward the horizon over a
    darker brown ground half, a sun disc of 8 texels' radius (at the
    default size) at 35 degrees of elevation, 10^4 times as bright as the
    sky around it, and 5 % multiplicative noise."""
    r = np.random.default_rng(seed)
    v = (np.arange(height) + 0.5) / height          # 0 zenith, 1 nadir
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]  # 1 zenith, 0 horizon
    sky = up * np.array([0.25, 0.45, 1.0]) + (1 - up) * np.array(
        [0.9, 0.95, 1.0])
    ground = np.array([0.12, 0.09, 0.06])
    rows = np.where((v < 0.5)[:, None], sky, ground)
    img = np.broadcast_to(rows[:, None, :], (height, width, 3)).copy()
    sun_v = (90.0 - 35.0) / 180.0
    sun_u = r.uniform(0.2, 0.8)
    radius = 8.0 * height / 1024
    yy, xx = np.mgrid[0:height, 0:width]
    disc = ((yy + 0.5 - sun_v * height) ** 2
            + (xx + 0.5 - sun_u * width) ** 2) <= radius ** 2
    img[disc] = 1e4 * np.array([1.0, 0.95, 0.85])
    img *= 1.0 + 0.05 * r.uniform(-1.0, 1.0, img.shape)
    return img.astype(np.float32)


def _envmap_meshes(subdiv, area_light, device):
    """The JAX package's envmap case (tests/test_megakernel.py
    ``_env_scene``): a floor at y = -1 (the unit rectangle scaled by 3), a
    ball of radius 0.6 at (0, -0.4, 0) and, with ``area_light``, a 0.5
    rectangle at y = 2 facing down; the meshes carry vertex normals, as
    there."""
    T = tf.compose

    def mesh(gen, to_world, bsdf, **kw):
        v, f, n, uv = gen(to_world)
        return Mesh.make(v, f, normals=n, uvs=uv, bsdf_index=bsdf,
                         device=device, **kw)

    meshes = [mesh(rectangle, T(tf.translate([0, -1, 0]),
                                tf.rotate([1, 0, 0], -90), tf.scale(3.0)),
                   0, id="floor"),
              mesh(lambda m: sphere_mesh(subdiv, m),
                   T(tf.translate([0, -0.4, 0]), tf.scale(0.6)),
                   1 if area_light else 0, id="ball")]
    if area_light:
        meshes.append(mesh(rectangle, T(tf.translate([0, 2.0, 0]),
                                        tf.rotate([1, 0, 0], 90),
                                        tf.scale(0.5)),
                           0, emitter_index=0, id="light"))
    return meshes


def envmap_scene(width: int = 256, height: int = 256,
                 area_light: bool = False, subdiv: int = 2, seed: int = 7,
                 env=None, device=None):
    """The envmap case under ``sky_envmap(seed=seed)`` (or the (H, W, 3)
    texels ``env``): a white diffuse (0.7) floor and ball, the envmap the
    only emitter.  With ``area_light`` also the JAX package's area light
    (radiance 10) before the envmap, which comes second, and the ball a
    Cu RoughConductor (alpha 0.2).  The camera looks from (0, 0.5, -4) at
    (0, -0.3, 0), fov 45, box filter.  324 faces at ``subdiv`` 2."""
    device = resolve_device(device)
    white = SmoothDiffuse(_rgb([0.7, 0.7, 0.7], device))
    bsdfs = [white]
    emitters = []
    if area_light:
        eta, k = (torch.tensor(x, device=device) for x in CONDUCTOR_IOR["Cu"])
        bsdfs.append(RoughConductor(eta=eta, k=k,
                                    alpha=torch.tensor(0.2, device=device)))
        emitters.append(AreaEmitter(radiance=_rgb([10.0] * 3, device)))
    emitters.append(EnvmapEmitter.create(
        sky_envmap(seed=seed) if env is None else env, device=device))
    sensor = PerspectiveCamera(
        to_world=torch.as_tensor(
            tf.look_at([0, 0.5, -4], [0, -0.3, 0], [0, 1, 0]), device=device),
        film=Film(width=width, height=height,
                  rfilter=ReconstructionFilter.box()),
        fov=45.0)
    return make_scene(_envmap_meshes(subdiv, area_light, device), bsdfs,
                      emitters, sensor, device)


def envmap_big_scene(width: int = 256, height: int = 256,
                     area_light: bool = True, subdiv: int = 6, seed: int = 7,
                     env=None, device=None):
    """``envmap_scene`` with the ball ``sphere_mesh(subdiv)``: 81,924
    triangles at the default, so it carries a host-built BVH."""
    return envmap_scene(width, height, area_light, subdiv, seed, env, device)
