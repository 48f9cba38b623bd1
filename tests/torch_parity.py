"""Helpers for the tests that hold mitsuba_tpu_torch against mitsuba_tpu.

Importing it caps torch's intra-op threads at 2 in the port's test
processes: the test runner's workers share the host's cores, and a whole
run counted more passes within its time limit with the cap than without.
"""
import numpy as np
import torch

torch.set_num_threads(2)


def export_scene(scene):
    """The numpy arrays of a JAX Scene, in the layout of
    mitsuba_tpu_torch.convert.scene_from_numpy."""
    from mitsuba_tpu.models.bsdfs import SmoothDiffuse, TwoSided
    from mitsuba_tpu.models.emitters import (AreaEmitter,
                                             DirectionalAreaEmitter,
                                             EnvmapEmitter)
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
        if b.id == "dispersive_dielectric":
            return {"type": b.id, **{k: arr(getattr(b, k)) for k in (
                "int_ior_d", "int_V_d", "ext_ior_d", "ext_V_d")}}
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
        if isinstance(e, (AreaEmitter, DirectionalAreaEmitter)):
            return {"type": e.id, "radiance": arr(e.radiance.value),
                    "sampling_weight": float(e.sampling_weight)}
        if e.id in ("point", "spot", "projector", "constant", "directional"):
            out = {"type": e.id,
                   "sampling_weight": float(e.sampling_weight)}
            for k in ("intensity", "position", "direction", "up", "scale",
                      "radiance"):
                if getattr(e, k, None) is not None:
                    out[k] = arr(getattr(e, k))
            if e.id == "directional":
                out["irradiance"] = arr(e.irradiance)
            if e.id == "projector":
                out.update(irradiance=texture(e.irradiance), fov=e.fov,
                           aspect=e.aspect)
            if e.id == "spot":
                out.update(cutoff_angle=e.cutoff_angle,
                           beam_width=e.beam_width)
            return out
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
    if hasattr(scene.sensor, "interfaces"):
        sensor = export_lens_camera(scene.sensor)
    else:
        s = scene.sensor
        sensor = {"to_world": arr(s.to_world), "fov": s.fov,
                  "fov_axis": s.fov_axis, "near_clip": s.near_clip,
                  "far_clip": s.far_clip, "width": s.film.width,
                  "height": s.film.height, "rfilter": s.film.rfilter.kind,
                  "sample_count": s.sampler.sample_count}
    meshes = [{"vertices": arr(m.vertices), "faces": arr(m.faces),
               "normals": arr(m.normals), "uvs": arr(m.uvs),
               "bsdf_index": m.bsdf_index, "emitter_index": m.emitter_index,
               "id": m.id} for m in scene.meshes]
    out = {"meshes": meshes, "bsdfs": bsdfs, "emitters": emitters,
           "sensor": sensor}
    sdf = getattr(scene, "scene_sdf", None)
    if sdf is not None:
        out["sdf"] = {"values": arr(sdf.values), "bbox_min": arr(sdf.bbox_min),
                      "bbox_max": arr(sdf.bbox_max),
                      "bsdf_index": sdf.bsdf_index, "id": sdf.id}
    if getattr(scene, "instances", ()):
        out["instances"] = [export_group(g) for g in scene.instances]
    an = getattr(scene, "scene_analytic", None)
    if an is not None:
        import dataclasses

        out["analytic"] = {f.name: getattr(an, f.name)
                           for f in dataclasses.fields(an)}
        out["analytic"].update({k: arr(out["analytic"][k]) for k in
                                out["analytic"] if k[:3] in ("sp_", "dk_",
                                                             "cy_", "cv_")})
    return out


def export_group(g):
    """A JAX InstancedGroup in the layout of scene_from_numpy's
    "instances" entries: its submeshes (split by ``fshape_g``, each its
    vertex range), transforms and id."""
    v, f = np.asarray(g.vertices), np.asarray(g.faces)
    sub, smooth = np.asarray(g.fshape_g), np.asarray(g.fsmooth)
    meshes = []
    for k in range(g.n_submeshes):
        fk = f[sub == k]
        lo, hi = int(fk.min()), int(fk.max()) + 1
        meshes.append({
            "vertices": v[lo:hi], "faces": fk - lo,
            "normals": (np.asarray(g.normals)[lo:hi] if smooth[sub == k][0]
                        else None),
            "uvs": np.asarray(g.uvs)[lo:hi],
            "bsdf_index": g.bsdf_of_submesh[k], "emitter_index": -1,
            "id": f"{g.id}{k}"})
    return {"submeshes": meshes, "transforms": np.asarray(g.to_world),
            "id": g.id}


def _jax_cornell_plus(width, height, rfilter, **kw):
    """The JAX package's ``cornell_box(width, height, rfilter)`` rebuilt
    by ``make_scene`` with the extra keywords (extra BSDFs under
    ``bsdfs``)."""
    from mitsuba_tpu.models.scene import make_scene
    from mitsuba_tpu.utils.scenes import cornell_box

    base = cornell_box(width=width, height=height, rfilter=rfilter)
    return make_scene(list(base.meshes) + kw.pop("meshes", []),
                      list(base.bsdfs) + kw.pop("bsdfs", []),
                      list(base.emitters), base.sensor, **kw)


def jax_curves_cornell(width, height, curve_type="bsplinecurve",
                       rfilter=None):
    """The JAX twin of mitsuba_tpu_torch.utils.scenes.curves_cornell: the
    curve loaded by ``load_dict`` as an ``{'analytic': True}`` shape."""
    from mitsuba_tpu.models.bsdfs import SmoothDiffuse
    from mitsuba_tpu.models.textures import ConstantTexture
    from mitsuba_tpu.utils.load import load_dict
    from mitsuba_tpu_torch.utils import scenes
    import jax.numpy as jnp

    prims = load_dict({"type": "scene", "curve": {
        "type": curve_type, "analytic": True,
        "control_points": np.asarray(scenes.CURVE_CP, np.float32),
        "radius": scenes.CURVE_RADIUS, "subdiv": scenes.CURVE_SUBDIV,
        "to_world": np.asarray(scenes.CURVE_TO_WORLD, np.float32),
        "bsdf": {"type": "diffuse"}}})
    an = prims.scene_analytic.replace(
        bsdf_index=(3,) * prims.scene_analytic.n_prims)
    bsdf = SmoothDiffuse(reflectance=ConstantTexture(jnp.asarray(
        scenes.CURVE_ALBEDO, jnp.float32)))
    return _jax_cornell_plus(width, height, rfilter, bsdfs=[bsdf],
                             analytic=an)


def jax_sdf_cornell(width, height, rfilter=None):
    """The JAX twin of mitsuba_tpu_torch.utils.scenes.sdf_cornell."""
    import jax.numpy as jnp
    from mitsuba_tpu.models.sdf import sphere_sdf_grid
    from mitsuba_tpu_torch.utils import scenes

    g = sphere_sdf_grid(radius=scenes.ANALYTIC_BALL["radius"],
                        res=scenes.SDF_RES, extent=0.5)
    c = jnp.asarray(scenes.ANALYTIC_BALL["center"], jnp.float32)
    sdf = g.replace(bbox_min=g.bbox_min + c, bbox_max=g.bbox_max + c)
    return _jax_cornell_plus(width, height, rfilter, sdf=sdf)


def jax_instanced_cornell(width, height, nx, ny, subdiv, rfilter=None,
                          flattened=False):
    """The JAX twin of mitsuba_tpu_torch.utils.scenes.instanced_cornell:
    an InstancedGroup of the ball, or its flattened copies
    (``instance_meshes``)."""
    from mitsuba_tpu.models.instancing import InstancedGroup
    from mitsuba_tpu.models.shapes import Mesh, instance_meshes, sphere_mesh
    from mitsuba_tpu_torch.utils.scenes import instance_transforms

    v, f, n, uv = sphere_mesh(subdiv)
    ball = Mesh.make(v, f, normals=n, uvs=uv, bsdf_index=1, id="ball")
    xf = instance_transforms(nx, ny)
    if flattened:
        return _jax_cornell_plus(width, height, rfilter,
                                 meshes=instance_meshes(ball, list(xf)))
    return _jax_cornell_plus(width, height, rfilter, instances=[
        InstancedGroup.create([ball], list(xf), id="balls")])


def jax_path_lanes(jscene, seed, spp, max_depth=6, rr_depth=5):
    """The JAX package's PathIntegrator radiance of each lane of its own
    camera rays (``sample_rays``), compiled as one program: an eager call
    compiles every operation outside the bounce loop on its own, which
    takes twice as long."""
    import jax
    import jax.numpy as jnp
    from mitsuba_tpu.models import integrators as jint

    @jax.jit
    def lanes(s):
        ray, _, _, lane = jint.sample_rays(s, jnp.uint32(seed), spp)
        return jint.PathIntegrator(max_depth, rr_depth).sample(
            s, ray, lane, jnp.uint32(seed), jnp.ones(lane.shape, bool))

    return np.asarray(lanes(jscene))


def export_interfaces(interfaces):
    """The arrays of a JAX lens camera's interfaces, in the layout of
    mitsuba_tpu_torch.convert.lens_camera_from_numpy's "interfaces"."""
    import dataclasses

    def glass(g):
        return {"name": g.name, "cauchy": np.asarray(g.cauchy),
                "sellmeier_B": np.asarray(g.sellmeier_B),
                "sellmeier_C": np.asarray(g.sellmeier_C),
                "use_cauchy": g.use_cauchy}

    def element(e):
        out = {f.name: np.asarray(getattr(e, f.name))
               for f in dataclasses.fields(e)
               if f.name not in ("left", "right", "kind", "newton_iters")}
        out.update(kind=e.kind, left=glass(e.left), right=glass(e.right))
        if e.kind == "asphere":
            out["newton_iters"] = e.newton_iters
        return out

    return [element(e) for e in interfaces]


def export_lens_camera(cam):
    """The arrays of a JAX RealisticLensCamera, in the layout of
    mitsuba_tpu_torch.convert.lens_camera_from_numpy."""
    return {"type": "realisticlens",
            "interfaces": export_interfaces(cam.interfaces),
            "to_world": np.asarray(cam.to_world),
            "pupil_min": np.asarray(cam.pupil_min),
            "pupil_max": np.asarray(cam.pupil_max),
            "film_z_position": np.asarray(cam.film_z_position),
            "width": cam.film.width, "height": cam.film.height,
            "rfilter": cam.film.rfilter.kind,
            "sample_count": cam.sampler.sample_count,
            "diagonal": cam.diagonal, "near_clip": cam.near_clip,
            "far_clip": cam.far_clip,
            "sample_exit_pupil": cam.sample_exit_pupil,
            "spectral": cam.spectral,
            "shutter_open_time": cam.shutter_open_time}


def export_lens(ls):
    """The prescription of a JAX LensSystem, in the layout of
    mitsuba_tpu_torch.convert.lens_from_numpy."""
    return {"surfaces": [{"type": "even_aspheric" if hasattr(s, "ai")
                          else "conic", "radial_extent": s.radial_extent,
                          **{k: np.asarray(v) for k, v in s.params.items()}}
                         for s in ls.surfaces],
            "materials": [{"name": m.name, "ior": np.asarray(m.ior),
                           "V_d": np.asarray(m.V_d)} for m in ls.materials],
            "aperture_index": ls.aperture_index, "n_rings": ls.n_rings,
            "n_sectors": ls.n_sectors, "baffle_scale": ls.baffle_scale}


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


def jax_analytic_cornell(width, height, sphere_light=False, rfilter=None):
    """The JAX twin of mitsuba_tpu_torch.utils.scenes.analytic_cornell:
    its prims loaded by ``load_dict`` as ``{'analytic': True}`` shapes
    (after the Cornell dictionary's three named BSDFs, so their inline
    BSDFs take indices 3 and 4), placed in the JAX package's
    ``cornell_box(width, height, rfilter)`` (the port's cornell_box's
    flat meshes) without its ceiling quad under ``sphere_light``."""
    from mitsuba_tpu.models.scene import make_scene
    from mitsuba_tpu.utils.load import load_dict
    from mitsuba_tpu.utils.scenes import cornell_box, cornell_box_dict
    from mitsuba_tpu_torch.utils import scenes

    box = cornell_box_dict(width, height)
    white = {"type": "ref", "id": "white"}
    d = {"type": "scene", **{k: box[k] for k in ("white", "green", "red")},
         "ball": {"type": "sphere", "analytic": True, "bsdf": white,
                  **scenes.ANALYTIC_BALL}}
    if sphere_light:
        d["lamp"] = {"type": "sphere", "analytic": True, "bsdf": white,
                     "emitter": box["light"]["emitter"],
                     **scenes.ANALYTIC_LAMP}
    d["cylinder"] = {"type": "cylinder", "analytic": True,
                     "bsdf": {"type": "conductor", "material": "Au"},
                     **scenes.ANALYTIC_CYLINDER}
    d["disk"] = {"type": "disk", "analytic": True,
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": list(scenes.DISK_ALBEDO)}},
                 **scenes.ANALYTIC_DISK}
    prims = load_dict(d)
    base = cornell_box(width=width, height=height, rfilter=rfilter)
    meshes = list(base.meshes)[1:] if sphere_light else list(base.meshes)
    return make_scene(meshes, list(base.bsdfs) + list(prims.bsdfs[3:]),
                      list(base.emitters), base.sensor,
                      analytic=prims.scene_analytic)


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
