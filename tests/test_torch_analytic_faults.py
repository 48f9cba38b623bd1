"""Two faults of the JAX package's shadow-boundary term that analytic
prims expose, each shown on the CPU beside the port's behaviour.

- The receiver: JAX decides "mesh receiver" by ``si_r.prim_index <
  faces.shape[0]`` (mitsuba_tpu/models/integrators/projective.py:722-724),
  but an analytic hit carries prim_index 0, so an analytic receiver takes
  mesh face 0's attached plane, against its own comment (:720-721).  The
  port decides by the shape slot and keeps the analytic receiver's
  detached tangent plane.
- The light: JAX builds its light-face set from mesh faces only (:476-485),
  empty when the one area light is an analytic sphere, and raises.  The
  port leaves the shadow term out there, logged.

The scene is tests/test_projective.py's ``_shadow_scene`` with its floor
an exact analytic disk and a small quad far outside it as mesh 0, whose
face 0 has nothing to do with any shadow.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.models.analytic import build_analytic as jbuild_analytic
from mitsuba_tpu.models.bsdfs import SmoothDiffuse as JDiffuse
from mitsuba_tpu.models.emitters import AreaEmitter as JAreaEmitter
from mitsuba_tpu.models.film import Film as JFilm
from mitsuba_tpu.models.film import ReconstructionFilter as JRFilter
from mitsuba_tpu.models.integrators import projective as jproj
from mitsuba_tpu.models.integrators.prb import _float_partition
from mitsuba_tpu.models.scene import make_scene as jmake_scene
from mitsuba_tpu.models.sensors import PerspectiveCamera as JCamera
from mitsuba_tpu.models.shapes import Mesh as JMesh
from mitsuba_tpu.models.shapes import rectangle as jrectangle
from mitsuba_tpu.models.textures import ConstantTexture as JConst
from mitsuba_tpu.utils.params import traverse as jtraverse
from mitsuba_tpu_torch import (PathProjectiveIntegrator,
                               build_silhouette_edges, prb_projective_render,
                               scene_from_numpy)
from mitsuba_tpu_torch.models.integrators import projective
from mitsuba_tpu_torch.utils.params import traverse, update
from torch_parity import export_scene, jax_analytic_cornell

SIZE, N, SEED = 32, 2048, 3
BLOCKER, DUMMY = "meshes.1.vertices", "meshes.0.vertices"


def _jax_disk_floor_scene():
    """The shadow scene with an analytic disk floor (radius 2, facing +z)
    and, as mesh 0, a small quad at (8, 8, 8) that neither casts nor
    receives a shadow."""
    def rect(*ms, **kw):
        return JMesh.make(*jrectangle(np.asarray(jtf.compose(*ms),
                                                 np.float32)), **kw)

    meshes = [rect(jtf.translate([8.0, 8.0, 8.0]), jtf.scale(0.05),
                   bsdf_index=0, id="dummy"),
              rect(jtf.translate([0.0, 0.0, 1.0]), jtf.scale(0.12),
                   bsdf_index=0, id="blocker"),
              rect(jtf.translate([0, 0, 2.0]), jtf.rotate([1, 0, 0], 180),
                   jtf.scale(0.1), bsdf_index=0, emitter_index=0, id="light")]
    floor = jbuild_analytic([("disk", np.zeros(3, np.float32),
                              np.array([2, 0, 0], np.float32),
                              np.array([0, 2, 0], np.float32),
                              np.array([0, 0, 1], np.float32), 0, -1, False,
                              "floor")])
    cam = JCamera(to_world=jnp.asarray(jtf.look_at([0, 0, 0.5], [0, 0, 0],
                                                   [0, 1, 0])),
                  fov=50.0, film=JFilm(width=SIZE, height=SIZE,
                                       rfilter=JRFilter.box()))
    return jmake_scene(meshes, [JDiffuse(reflectance=JConst(jnp.full(
        (3,), 0.8)))], [JAreaEmitter(radiance=JConst(jnp.full((3,), 120.0)))],
        cam, use_bvh=False, analytic=floor)


def _ramp(size):
    return np.broadcast_to(np.arange(size, dtype=np.float32)[None, :, None]
                           / size, (size, size, 3)).copy()


def test_jax_analytic_receiver_takes_face_0_plane():
    """JAX's shadow pass on the disk-floor scene (2,048 samples) moves the
    shadow with mesh 0, the far quad, whose face 0 lends the analytic floor
    its plane: a nonzero gradient for vertices that touch no shadow.  The
    port's pass on the same samples gives them none, and its receivers on
    the disk keep their detached plane; both give the blocker a
    gradient."""
    jscene = _jax_disk_floor_scene()
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    w = _ramp(SIZE)
    jpass = jax.jit(jproj._indirect_pass, static_argnames=(
        "n_samples", "eps_frac", "collect", "indirect_depth"))
    jg, _, _ = jpass(jscene, jproj.build_silhouette_edges(jscene),
                     jnp.asarray(w), SEED, n_samples=N, eps_frac=0.01)
    jg = {k: np.asarray(v) for k, v in jtraverse(
        _float_partition(jscene)[2](jg)).items()}
    edges = build_silhouette_edges(scene)
    g, _, _ = projective._indirect_pass(scene, edges, torch.tensor(w), SEED, N)
    assert np.abs(jg[DUMMY]).sum() > 0           # the reference's fault
    assert not g[DUMMY].any()                    # the port's
    assert np.abs(jg[BLOCKER]).sum() > 0 and g[BLOCKER].abs().sum() > 0
    det = projective._detached(scene)
    with torch.no_grad():
        ctx, geo, lights = projective._shadow_setup(det, edges)
        s = projective._shadow_pass(det, ctx, geo, lights, torch.tensor(w),
                                    SEED, N, 0.01, 1)
    on_disk = projective._contributing(s)
    assert on_disk.numel() > 20 and not s.mesh_recv[on_disk].any()


def test_jax_shadow_term_raises_for_a_sphere_light(caplog):
    """JAX's shadow term on the analytic Cornell box lit by its sphere
    lamp raises (its light-face set is empty); the port's
    prb_projective_render there logs the shadow term's absence and gives
    finite gradients, the analytic silhouettes and the primary term
    included."""
    jscene = jax_analytic_cornell(8, 8, sphere_light=True)
    with pytest.raises(TypeError):
        jproj.indirect_boundary_grads(
            jscene, jproj.build_silhouette_edges(jscene),
            jnp.ones((8, 8, 3)), SEED, n_samples=256)
    scene = scene_from_numpy(export_scene(jscene), device="cpu")
    keys = ("scene_analytic.sp_center", "scene_analytic.sp_radius",
            "meshes.6.vertices", "sensor.to_world")
    leaves = {k: traverse(scene)[k].clone().requires_grad_() for k in keys}
    integ = PathProjectiveIntegrator(3, 5, sppp=512, n_sub=1, sppi=1024)
    with caplog.at_level(logging.INFO):
        img = prb_projective_render(update(scene, leaves),
                                    build_silhouette_edges(scene), integ,
                                    SEED, 2, device="cpu")
        img.mean().backward()
    assert "shadow-boundary term is left out" in caplog.text
    assert "analytic sphere" in caplog.text
    for k, v in leaves.items():
        assert torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0, k


@pytest.mark.slow
def test_analytic_receiver_shadow_matches_fd():
    """The port's blocker x-translation gradient on the disk-floor scene
    (32x32, spp 32, sppp 4096, n_sub 2, depth 2) within 0.3 |fd| + 0.05
    of central differences (h = 0.03), the bar of
    tests/test_projective.py's shadow case; without the shadow term under
    0.3 |fd|."""
    import dataclasses

    scene = scene_from_numpy(export_scene(_jax_disk_floor_scene()),
                             device="cpu")
    edges = build_silhouette_edges(scene)
    w = torch.tensor(_ramp(SIZE))
    integ = PathProjectiveIntegrator(max_depth=2, sppp=4096, n_sub=2)
    spp, h = 32, 0.03
    v0 = traverse(scene)[BLOCKER]

    def grad(it):
        leaf = v0.clone().requires_grad_()
        img = prb_projective_render(update(scene, {BLOCKER: leaf}), edges, it,
                                    0, spp, device="cpu")
        torch.sum(img * w).backward()
        return float(leaf.grad[:, 0].sum())

    def loss(dx):
        v = v0.clone()
        v[:, 0] += dx
        with torch.no_grad():
            return float(torch.sum(prb_projective_render(
                update(scene, {BLOCKER: v}), edges, integ, 0, spp,
                device="cpu") * w))

    fd = (loss(h) - loss(-h)) / (2 * h)
    ad = grad(integ)
    assert np.isfinite(ad) and abs(ad - fd) < 0.3 * abs(fd) + 0.05, (ad, fd)
    ad0 = grad(dataclasses.replace(integ, indirect=False))
    assert abs(ad0) < 0.3 * abs(fd), (ad0, fd)
