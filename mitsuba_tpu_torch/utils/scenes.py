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

``analytic_cornell`` is the Cornell box with exact analytic prims
(models/analytic.py): ``big_scene``'s ball as an exact sphere, a
smooth-conductor cylinder on the floor and a diffuse disk on the back
wall, optionally lit by an analytic sphere light instead of the
ceiling quad.

``curves_cornell``, ``sdf_cornell`` and ``instanced_cornell`` put the
other shapes in the Cornell box: the JAX package's test curve
(tests/test_analytic_curves.py) as an exact linear or cubic B-spline
curve, or tessellated; a sphere SDF grid where ``analytic_cornell``'s
ball stands; a grid of instanced icospheres, or its flattened twin.

``emissive_quad`` is the JAX package's acceptance case of boundary
gradients (tests/test_projective.py ``_quad_scene``): a quad of constant
radiance on black, whose translation gradient is all boundary term.
``shadow_scene`` and ``probe_panel`` are its cases of the shadow term
(``_shadow_scene``, ``_recv_scene`` and ``_probe_panel_scene``): a
blocker outside the camera's view whose shadow alone is seen, and a
panel lit only by the floor's bounce, its gradient all in the shadow
seen through one bounce, or two by way of a mirror.

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
from ..models.analytic import analytic_prim, build_analytic
from ..models.instancing import InstancedGroup
from ..models.sdf import SDFGrid, sphere_sdf_grid
from ..models.bsdfs import (CONDUCTOR_IOR, RoughConductor, RoughPlastic,
                            SmoothConductor, SmoothDiffuse, SmoothPlastic,
                            TwoSided)
from ..models.emitters import AreaEmitter, EnvmapEmitter
from ..models.film import Film, ReconstructionFilter
from ..models.scene import make_scene
from ..models.sensors import PerspectiveCamera
from ..models.shapes import (Mesh, bspline_centerline, bspline_curve_mesh,
                             cube, instance_meshes, linear_curve_mesh,
                             rectangle, sphere_mesh)
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


def cornell_box_dict(width: int = 256, height: int = 256, spp: int = 64):
    """The reference's scene dictionary (util.py:565), as the JAX package
    gives it, for ``utils/load.py::load_dict``: ``cornell_box``'s walls,
    boxes, light and camera, its film's gaussian filter, the independent
    sampler at ``spp`` and a ``path`` integrator of depth 8.  The
    transforms are float32 numpy, composed as ``cornell_box`` composes
    them."""
    T = tf.compose

    def rgb(v):
        return {"type": "rgb", "value": v}

    def ref(name):
        return {"type": "ref", "id": name}

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "perspective",
            "fov_axis": "smaller",
            "near_clip": 0.001,
            "far_clip": 100.0,
            "fov": 39.3077,
            "to_world": tf.look_at([0, 0, 3.90], [0, 0, 0], [0, 1, 0]),
            "sampler": {"type": "independent", "sample_count": spp},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "gaussian"}},
        },
        "white": {"type": "diffuse",
                  "reflectance": rgb([0.885809, 0.698859, 0.666422])},
        "green": {"type": "diffuse",
                  "reflectance": rgb([0.105421, 0.37798, 0.076425])},
        "red": {"type": "diffuse",
                "reflectance": rgb([0.570068, 0.0430135, 0.0443706])},
        "light": {
            "type": "rectangle",
            "to_world": T(tf.translate([0.0, 0.99, 0.01]),
                          tf.rotate([1, 0, 0], 90),
                          tf.scale([0.23, 0.19, 0.19])),
            "bsdf": ref("white"),
            "emitter": {"type": "area",
                        "radiance": rgb([18.387, 13.9873, 6.75357])},
        },
        "floor": {"type": "rectangle",
                  "to_world": T(tf.translate([0.0, -1.0, 0.0]),
                                tf.rotate([1, 0, 0], -90)),
                  "bsdf": ref("white")},
        "ceiling": {"type": "rectangle",
                    "to_world": T(tf.translate([0.0, 1.0, 0.0]),
                                  tf.rotate([1, 0, 0], 90)),
                    "bsdf": ref("white")},
        "back": {"type": "rectangle",
                 "to_world": T(tf.translate([0.0, 0.0, -1.0])),
                 "bsdf": ref("white")},
        "green-wall": {"type": "rectangle",
                       "to_world": T(tf.translate([1.0, 0.0, 0.0]),
                                     tf.rotate([0, 1, 0], -90)),
                       "bsdf": ref("green")},
        "red-wall": {"type": "rectangle",
                     "to_world": T(tf.translate([-1.0, 0.0, 0.0]),
                                   tf.rotate([0, 1, 0], 90)),
                     "bsdf": ref("red")},
        "small-box": {"type": "cube",
                      "to_world": T(tf.translate([0.335, -0.7, 0.38]),
                                    tf.rotate([0, 1, 0], -17),
                                    tf.scale(0.3)),
                      "bsdf": ref("white")},
        "large-box": {"type": "cube",
                      "to_world": T(tf.translate([-0.33, -0.4, -0.28]),
                                    tf.rotate([0, 1, 0], 18.25),
                                    tf.scale([0.3, 0.61, 0.3])),
                      "bsdf": ref("white")},
    }


# the lights that delta_lights_dict adds to the Cornell box: positions
# and directions inside the box or through its open front
POINT_LIGHT = dict(position=[-0.4, 0.6, 0.3], intensity=[1.5, 1.2, 0.9])
SPOT_LIGHT = dict(position=[0.5, 0.7, 0.6], direction=[-0.4, -1.0, -0.5],
                  cutoff_angle=28.0, beam_width=18.0,
                  intensity=[4.0, 4.0, 5.0])
PROJECTOR = dict(position=[0.0, 0.2, 1.6], direction=[0.0, -0.1, -1.0],
                 up=[0.0, 1.0, 0.0], fov=40.0, scale=3.0)
SKY = dict(radiance=[0.3, 0.35, 0.45])
SUN = dict(direction=[-0.2, -0.3, -1.0], irradiance=[2.0, 1.8, 1.5])
DELTA_VARIANTS = ("point_spot", "projector", "constant", "directional")


def delta_lights_dict(width: int = 256, height: int = 256, spp: int = 64,
                      variant: str = "point_spot", bitmap=None):
    """``cornell_box_dict`` with more lights beside its area light:
    "point_spot" a point light and a spot light, "projector" an image
    projector of the bitmap file ``bitmap`` shining through the open
    front, "constant" a constant sky, "directional" a sun through the
    front."""
    d = cornell_box_dict(width, height, spp)

    def rgb(v):
        return {"type": "rgb", "value": v}

    if variant == "point_spot":
        d["point"] = {"type": "point", "position": POINT_LIGHT["position"],
                      "intensity": rgb(POINT_LIGHT["intensity"])}
        d["spot"] = {"type": "spot", **{k: v for k, v in SPOT_LIGHT.items()
                                        if k != "intensity"},
                     "intensity": rgb(SPOT_LIGHT["intensity"])}
    elif variant == "projector":
        d["projector"] = {"type": "projector", **PROJECTOR,
                          "irradiance": {"type": "bitmap",
                                         "filename": str(bitmap)}}
    elif variant == "constant":
        d["sky"] = {"type": "constant", "radiance": rgb(SKY["radiance"])}
    elif variant == "directional":
        d["sun"] = {"type": "directional", "direction": SUN["direction"],
                    "irradiance": rgb(SUN["irradiance"])}
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return d


def single_emitter_plane(width: int = 64, height: int = 64, device=None):
    """A diffuse floor lit by a square area light above it, a box filter
    (the JAX package's small sanity scene), on ``device`` (default: the
    GPU)."""
    device = resolve_device(device)
    white = SmoothDiffuse(_rgb([0.5, 0.5, 0.5], device))
    em = AreaEmitter(radiance=_rgb([1.0, 1.0, 1.0], device))
    floor = Mesh.make(*rectangle(tf.compose(tf.translate([0, -1, 0]),
                                            tf.rotate([1, 0, 0], -90))),
                      device=device, bsdf_index=0, id="floor")
    light = Mesh.make(*rectangle(tf.compose(tf.translate([0, 1, 0]),
                                            tf.rotate([1, 0, 0], 90),
                                            tf.scale(0.5))),
                      device=device, bsdf_index=0, emitter_index=0,
                      id="light")
    sensor = PerspectiveCamera(
        to_world=torch.as_tensor(tf.look_at([0, 0, 3.0], [0, 0, 0],
                                            [0, 1, 0]), device=device),
        film=Film(width=width, height=height,
                  rfilter=ReconstructionFilter.box()), fov=45.0)
    return make_scene([floor, light], [white], [em], sensor, device)


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


# analytic_cornell's prims: big_scene's ball; a cylinder standing on the
# floor in the front left corner, clear of both boxes (the large box ends
# at z = 0.10, the small box at x = -0.04); a disk 0.01 off the back wall,
# above the large box as the camera sees it
ANALYTIC_BALL = dict(center=(0.3, 0.2, 0.2), radius=0.35)
ANALYTIC_CYLINDER = dict(p0=(-0.55, -1.0, 0.45), p1=(-0.55, -0.45, 0.45),
                         radius=0.15)
ANALYTIC_DISK = dict(center=(-0.45, 0.55, -0.99), radius=0.22)
ANALYTIC_LAMP = dict(center=(0.0, 0.8, 0.0), radius=0.12)
DISK_ALBEDO = (0.2, 0.35, 0.75)


def analytic_cornell(width: int = 256, height: int = 256,
                     sphere_light: bool = False, device=None):
    """``cornell_box`` plus three exact analytic prims: the ball of
    ``big_scene`` as a sphere (center (0.3, 0.2, 0.2), radius 0.35, BSDF
    0, white diffuse), a Au ``SmoothConductor`` cylinder standing on the
    floor (axis from (-0.55, -1, 0.45) to (-0.55, -0.45, 0.45), radius
    0.15, open ends, BSDF 3) and a diffuse disk (albedo (0.2, 0.35,
    0.75), BSDF 4) 0.01 in front of the back wall (center (-0.45, 0.55,
    -0.99), radius 0.22, facing +z).  All are in view, and none cuts a
    box or the ball.  ``sphere_light`` replaces the ceiling quad by an
    analytic sphere light (center (0, 0.8, 0), radius 0.12) of the quad's
    radiance.  On ``device`` (default: the GPU)."""
    device = resolve_device(device)
    base = cornell_box(width, height, device=device)
    bsdfs = list(base.bsdfs) + [
        SmoothConductor(*(torch.tensor(x, dtype=torch.float32, device=device)
                          for x in CONDUCTOR_IOR["Au"])),
        SmoothDiffuse(_rgb(list(DISK_ALBEDO), device))]
    prims = [analytic_prim({"type": "sphere", **ANALYTIC_BALL, "id": "ball"},
                           bsdf_index=0)]
    meshes = list(base.meshes)
    if sphere_light:
        meshes = meshes[1:]          # the ceiling quad is mesh 0
        prims.append(analytic_prim({"type": "sphere", **ANALYTIC_LAMP,
                                    "id": "lamp"}, bsdf_index=0,
                                   emitter_index=0))
    prims += [analytic_prim({"type": "disk", **ANALYTIC_DISK, "id": "disk"},
                            bsdf_index=4),
              analytic_prim({"type": "cylinder", **ANALYTIC_CYLINDER,
                             "id": "cylinder"}, bsdf_index=3)]
    return make_scene(meshes, bsdfs, list(base.emitters), base.sensor, device,
                      analytic=build_analytic(prims, device=device))


# curves_cornell's curve: the JAX tests' control points and radius
# (tests/test_analytic_curves.py:19-21), scaled by 0.4 to above the small
# box, in front of the large one
CURVE_CP = ((-1.0, 0.0, 0.0), (-0.3, 0.4, 0.1), (0.3, -0.2, -0.1),
            (1.0, 0.1, 0.0))
CURVE_RADIUS = 0.25
CURVE_TO_WORLD = tf.compose(tf.translate([0.05, 0.3, 0.35]), tf.scale(0.4))
CURVE_ALBEDO = (0.75, 0.55, 0.2)
# the B-spline's sub-segments a parent segment, and the sides of the
# tessellated twin's tube
CURVE_SUBDIV = 8
CURVE_TUBE_SIDES = 48
# sdf_cornell's grid: SDF_RES^3 nodes
SDF_RES = 32


def curves_cornell(width: int = 256, height: int = 256,
                   curve_type: str = "bsplinecurve",
                   tessellated: bool = False, device=None):
    """``cornell_box`` plus the curve of ``CURVE_CP`` (radius
    ``CURVE_RADIUS``) under ``CURVE_TO_WORLD``, diffuse of
    ``CURVE_ALBEDO`` (BSDF 3): exact analytic prims of ``curve_type``
    ("linearcurve", one a segment, or "bsplinecurve", ``CURVE_SUBDIV``
    sub-segments a parent segment), or with ``tessellated`` its tube mesh
    of ``CURVE_TUBE_SIDES`` sides (the B-spline's centre line at 4 *
    ``CURVE_SUBDIV`` samples a segment) and two icosphere caps at the
    curve's ends, the reference's spherical end caps.  On ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    base = cornell_box(width, height, device=device)
    bsdfs = list(base.bsdfs) + [SmoothDiffuse(_rgb(list(CURVE_ALBEDO),
                                                   device))]
    m = np.asarray(CURVE_TO_WORLD, np.float32)
    if not tessellated:
        prims = analytic_prim({"type": curve_type, "control_points": CURVE_CP,
                               "radius": CURVE_RADIUS, "to_world": m,
                               "subdiv": CURVE_SUBDIV, "id": "curve"},
                              bsdf_index=3)
        return make_scene(base.meshes, bsdfs, base.emitters, base.sensor,
                          device, analytic=build_analytic(prims, device))
    cp = np.asarray(CURVE_CP, np.float32) @ m[:3, :3].T + m[:3, 3]
    r = CURVE_RADIUS * float(np.linalg.norm(m[:3, 0]))
    if curve_type == "bsplinecurve":
        v, f, n, uv = bspline_curve_mesh(cp, r, CURVE_TUBE_SIDES,
                                         4 * CURVE_SUBDIV)
        pts, rads = bspline_centerline(cp, r, 4 * CURVE_SUBDIV)
        ends = [(pts[0], rads[0]), (pts[-1], rads[-1])]
    else:
        v, f, n, uv = linear_curve_mesh(cp, r, CURVE_TUBE_SIDES)
        ends = [(cp[0], r), (cp[-1], r)]
    meshes = list(base.meshes) + [Mesh.make(v, f, normals=n, uvs=uv,
                                            bsdf_index=3, id="curve",
                                            device=device)]
    for i, (c, rc) in enumerate(ends):
        cv, cf, cn, cuv = sphere_mesh(3, tf.compose(tf.translate(c),
                                                    tf.scale(float(rc))))
        meshes.append(Mesh.make(cv, cf, normals=cn, uvs=cuv, bsdf_index=3,
                                id=f"cap{i}", device=device))
    return make_scene(meshes, bsdfs, base.emitters, base.sensor, device)


def sdf_cornell(width: int = 256, height: int = 256, device=None):
    """``cornell_box`` plus a sphere SDF grid (``sphere_sdf_grid``,
    ``SDF_RES``^3 nodes over the ball's box, half-width 0.5) where ``analytic_cornell``'s
    ball stands (``ANALYTIC_BALL``, white diffuse).  On ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    base = cornell_box(width, height, device=device)
    g = sphere_sdf_grid(radius=ANALYTIC_BALL["radius"], res=SDF_RES,
                        extent=0.5, device=device)
    c = torch.tensor(ANALYTIC_BALL["center"], dtype=torch.float32,
                     device=device)
    sdf = SDFGrid(values=g.values, bbox_min=g.bbox_min + c,
                  bbox_max=g.bbox_max + c, bsdf_index=0, id="ball")
    return make_scene(base.meshes, base.bsdfs, base.emitters, base.sensor,
                      device, sdf=sdf)


def instance_transforms(nx: int, ny: int, span: float = 0.6, z: float = 0.9):
    """The (nx * ny, 4, 4) to_world of ``instanced_cornell``'s grid: x and
    y evenly over [-span, span] (x major), at depth z, each scaled by
    min(0.12, 0.56 / max(nx, ny)) (0.035 at 16 x 16)."""
    scale = min(0.12, 0.56 / max(nx, ny))
    out = []
    for i in range(nx):
        for j in range(ny):
            x = -span + 2 * span * i / max(nx - 1, 1)
            y = -span + 2 * span * j / max(ny - 1, 1)
            out.append(np.asarray(tf.compose(tf.translate([x, y, z]),
                                             tf.scale(scale)), np.float32))
    return np.stack(out)


def instanced_cornell(width: int = 256, height: int = 256, nx: int = 16,
                      ny: int = 16, subdiv: int = 4, flattened: bool = False,
                      device=None):
    """``cornell_box`` plus an nx x ny grid of ``sphere_mesh(subdiv)``
    balls (smooth, green diffuse, BSDF 1) under ``instance_transforms``:
    one ``InstancedGroup`` of the ball and its nx * ny transforms, or
    with ``flattened`` the copies as meshes (``instance_meshes``).  On
    ``device`` (default: the GPU)."""
    device = resolve_device(device)
    base = cornell_box(width, height, device=device)
    v, f, n, uv = sphere_mesh(subdiv)
    ball = Mesh.make(v, f, normals=n, uvs=uv, bsdf_index=1, id="ball",
                     device=device)
    xf = instance_transforms(nx, ny)
    if flattened:
        return make_scene(list(base.meshes) + instance_meshes(ball, xf),
                          base.bsdfs, base.emitters, base.sensor, device)
    group = InstancedGroup.create([ball], xf, id="balls", device=device)
    return make_scene(base.meshes, base.bsdfs, base.emitters, base.sensor,
                      device, instances=[group])


def emissive_quad(width: int = 32, height: int = 32, dx: float = 0.0,
                  device=None):
    """An emissive quad (half-size 0.5, radiance 1) at z = 0, moved by
    ``dx`` in x, on black, seen from z = 3 (fov 45, a box filter): the
    scene of tests/test_projective.py ``_quad_scene``."""
    device = resolve_device(device)
    v, f, n, uv = rectangle(tf.compose(tf.translate([dx, 0.0, 0.0]),
                                       tf.scale(0.5)))
    quad = Mesh.make(v, f, normals=n, uvs=uv, bsdf_index=0, emitter_index=0,
                     id="quad", device=device)
    cam = PerspectiveCamera(
        to_world=torch.as_tensor(tf.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                                 device=device),
        fov=45.0, film=Film(width=width, height=height,
                            rfilter=ReconstructionFilter.box()))
    return make_scene([quad], [SmoothDiffuse(_rgb([0.0, 0.0, 0.0], device))],
                      [AreaEmitter(radiance=_rgb([1.0, 1.0, 1.0], device))],
                      cam, device)


def _rect(*transforms, device, **kw):
    v, f, n, uv = rectangle(tf.compose(*transforms))
    return Mesh.make(v, f, normals=n, uvs=uv, device=device, **kw)


def shadow_scene(width: int = 32, height: int = 32, bx: float = 0.0,
                 floor_z: float = 0.0, blocker_x: float = 0.0,
                 device=None):
    """A floor (half-size 2) seen top-down from z = 0.5 (fov 50, a box
    filter), a small square blocker (half-size 0.12) at z = 1, moved by
    ``bx`` in x, and a small light (half-size 0.1, radiance 120) at z = 2
    facing down: the blocker is outside the view, so its x-translation
    gradient is all shadow-boundary term (tests/test_projective.py
    ``_shadow_scene``).  ``floor_z`` lifts the floor and ``blocker_x``
    sets the blocker's resting x: (``floor_z``, 0.06) is ``_recv_scene``,
    whose floor gradient is the receiver-motion term."""
    device = resolve_device(device)
    meshes = [
        _rect(tf.translate([0, 0, floor_z]), tf.scale(2.0), bsdf_index=0,
              id="floor", device=device),
        _rect(tf.translate([blocker_x + bx, 0.0, 1.0]), tf.scale(0.12),
              bsdf_index=0, id="blocker", device=device),
        _rect(tf.translate([0, 0, 2.0]), tf.rotate([1, 0, 0], 180),
              tf.scale(0.1), bsdf_index=0, emitter_index=0, id="light",
              device=device)]
    cam = PerspectiveCamera(
        to_world=torch.as_tensor(tf.look_at([0, 0, 0.5], [0, 0, 0],
                                            [0, 1, 0]), device=device),
        fov=50.0, film=Film(width=width, height=height,
                            rfilter=ReconstructionFilter.box()))
    return make_scene(meshes, [SmoothDiffuse(_rgb([0.8] * 3, device))],
                      [AreaEmitter(radiance=_rgb([120.0] * 3, device))], cam,
                      device)


def probe_panel(width: int = 24, height: int = 24, bx: float = 0.0,
                mirror: bool = False, device=None):
    """A white panel (half-size 0.2) facing -x at x = 0.45 over the
    shadow of a blocker (half-size 0.2, moved by ``bx``) at z = 0.75, lit
    only by the floor's bounce of a light (radiance 240) in the panel's
    plane, and a camera (fov 18, a box filter) filled by the panel: the
    blocker's gradient flows only through the shadow seen through one
    bounce (tests/test_projective.py ``_probe_panel_scene``).  With
    ``mirror`` the camera sees the panel in a small conductor mirror
    (eta 0.05, k 4), so the gradient sits at two bounces."""
    device = resolve_device(device)
    meshes = [
        _rect(tf.translate([0, 0, 0]), tf.scale(2.0), bsdf_index=0,
              id="floor", device=device),
        _rect(tf.translate([bx, 0.0, 0.75]), tf.scale(0.2), bsdf_index=0,
              id="blocker", device=device),
        _rect(tf.translate([0.6, 0, 1.5]), tf.rotate([1, 0, 0], 180),
              tf.scale(0.1), bsdf_index=0, emitter_index=0, id="light",
              device=device),
        _rect(tf.translate([0.45, 0, 0.3]), tf.rotate([0, 1, 0], -90),
              tf.scale(0.2), bsdf_index=0, id="panel", device=device)]
    bsdfs = [SmoothDiffuse(_rgb([0.8] * 3, device))]
    if mirror:
        meshes.append(_rect(tf.translate([-0.1, 0.25, 0.3]),
                            tf.rotate([0, 1, 0], 90), tf.scale(0.08),
                            bsdf_index=1, id="mirror", device=device))
        bsdfs.append(SmoothConductor(eta=torch.full((3,), 0.05, device=device),
                                     k=torch.full((3,), 4.0, device=device)))
        pose = tf.look_at([0.18, 0.25, 0.3], [-0.1, 0.25, 0.3], [0, 0, 1])
    else:
        pose = tf.look_at([-0.68, 0, 0.3], [0.45, 0, 0.3], [0, 0, 1])
    cam = PerspectiveCamera(
        to_world=torch.as_tensor(pose, device=device), fov=18.0,
        film=Film(width=width, height=height,
                  rfilter=ReconstructionFilter.box()))
    return make_scene(meshes, bsdfs,
                      [AreaEmitter(radiance=_rgb([240.0] * 3, device))], cam,
                      device)


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
