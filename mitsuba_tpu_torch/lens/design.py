"""Lens-design optimization: field sources and the ``DesignProblem`` loop
(mitsuba_tpu/lens/design.py; reference lens_design/design_problem.py of
the fork).

A ``FieldSource`` is a collimated disk (a ``DirectionalAreaEmitter``) aimed
at the entrance pupil at one field angle, with a small perspective
sensor placed behind the lens by the geometric tracer
(``PRBBasicIntegrator.trace``) to watch its spot (design_problem.py:
12-267).  ``DesignProblem`` builds the geometric-tracer scene and the
particle tracer's render scene (:364-420) and runs Adam on the RMS spot
loss (:495-586); ``optimize(fixed_efl=...)`` solves the rear surface at
every step to hold the effective focal length (ConstrainedEFLProblem,
:656).

The chain from the parameter dict to the loss is plain PyTorch: the
surfaces' sag and normals (``LensSystem.remesh``), the dispersive
interfaces, the particle tracer's render (its hit queries on detached
rays, the BVH refitted to the remeshed lens at every render) and the RMS
loss; ``torch.autograd.grad`` takes each sensor's gradient, and the
sensors' gradients are summed (``accumulate_sensor_grads``), as the JAX
package's ``split_jits`` does.  Two of the JAX package's faults are
repaired (ROADMAP.md, Queue 3): a sensor's draw counts only when its loss
is finite too, and the per-sensor drop counts survive a resumed
checkpoint.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transform as tf
from ..core.records import Ray
from ..models.bsdfs import SmoothDiffuse
from ..models.emitters import DirectionalAreaEmitter
from ..models.film import Film, ReconstructionFilter
from ..models.integrators import (ParticleTracerIntegrator,
                                  PRBBasicIntegrator, render)
from ..models.scene import make_scene
from ..models.sensors import PerspectiveCamera
from ..models.shapes import Mesh, disk_mesh, rectangle
from ..models.textures import ConstantTexture
from ..utils.elastic import CheckpointedLoop, nan_guard_step
from ..utils.optimizers import Adam
from .lens_system import LensSystem
from .losses import rms_loss


class FieldSource:
    """One collimated field-angle source and the sensor that watches its
    spot (design_problem.py:12-267)."""

    def __init__(self, name, origin, target, radius, resolution=(64, 64),
                 fov=45.0, init_camera_z=0.9, radiance=0.05):
        self.name = name
        self.origin = np.asarray(origin, np.float32)
        self.target = np.asarray(target, np.float32)
        self.radius = float(radius)
        self.resolution = resolution
        self.fov = fov
        self.init_camera_z = init_camera_z
        self.radiance = radiance
        self.camera_pos = None

    def central_ray(self, device, n_probe: int = 9):
        """The chief ray and eight probes 1e-3 radius around it.  The exact
        chief ray may pass through the shared centre vertex of the lens
        fans, where a Moller-Trumbore test that is not watertight can miss
        every face; the film position is averaged over the rays that get
        through."""
        d = self.target - self.origin
        d = d / np.linalg.norm(d)
        t1 = np.cross(d, np.array([0.0, 1.0, 0.0], np.float32))
        t1 /= max(np.linalg.norm(t1), 1e-12)
        t2 = np.cross(d, t1)
        ang = np.linspace(0.0, 2 * np.pi, n_probe - 1, endpoint=False)
        eps = 1e-3 * self.radius
        offs = np.concatenate(
            [np.zeros((1, 3), np.float32),
             (eps * (np.cos(ang)[:, None] * t1[None]
                     + np.sin(ang)[:, None] * t2[None])).astype(np.float32)])
        o = self.origin[None] + offs
        dirs = self.target[None] - o
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        o, dirs = (torch.tensor(np.asarray(x, np.float32), device=device)
                   for x in (o, dirs))
        return Ray(o=o, d=dirs, maxt=torch.full((n_probe,), float("inf"),
                                                device=device))

    def source_mesh_emitter(self, emitter_index, device):
        """The source disk (32 faces, black) and its collimated emitter
        aimed at ``target`` (design_problem.py:57-69)."""
        look = tf.look_at(self.origin, self.target, [0, 1, 0])
        m = tf.compose(look, tf.scale(self.radius))
        mesh = Mesh.make(*disk_mesh(n_seg=32, to_world=m), bsdf_index=0,
                         emitter_index=emitter_index, id=f"source_{self.name}",
                         device=device)
        em = DirectionalAreaEmitter(radiance=ConstantTexture(
            torch.full((3,), self.radiance, device=device)))
        return mesh, em

    def make_sensor(self, geo_tracer, lens_system, device):
        """The spot camera, placed over where the chief ray meets the film
        (design_problem.py:192-247 get_sensor_dict)."""
        _, _, valid, film_p = geo_tracer(self.central_ray(device))
        valid = valid.cpu().numpy()
        if not valid.any():
            raise RuntimeError(
                f"source {self.name}: the central ray was not transmitted")
        film_p = film_p.detach().cpu().numpy()[valid].mean(axis=0)
        rear_z = float(lens_system.rear_z)
        near_clip = min(0.005, rear_z * 0.1)
        z_cam = max(self.init_camera_z * rear_z, 1.1 * near_clip)
        self.camera_pos = np.array([film_p[0], film_p[1], z_cam], np.float32)
        to_world = tf.look_at(
            self.camera_pos, [self.camera_pos[0], self.camera_pos[1], -1.0],
            [0, 1, 0])
        film = Film(width=self.resolution[0], height=self.resolution[1],
                    rfilter=ReconstructionFilter.tent())
        return PerspectiveCamera(
            to_world=torch.tensor(to_world, device=device), film=film,
            fov=self.fov, near_clip=near_clip, far_clip=z_cam + 1.0)


def _all_finite(v, g):
    return bool(torch.isfinite(v).all()) and all(
        bool(torch.isfinite(x).all()) for x in g.values())


def accumulate_sensor_grads(grad_fns, p, seed, retries=2):
    """Sum the per-sensor (value, gradient) of ``fn(p, seed)`` for each fn
    of ``grad_fns``, redrawing a non-finite one.

    A sensor's draw with a non-finite loss or gradient (a grazing
    total-internal-reflection lane through a strongly aspheric surface,
    say) is redrawn with a decorrelated seed up to ``retries`` times and
    dropped only when every draw fails: dropping at once would starve
    exactly the hardest (widest-field) sensors of updates.  Survivors
    are summed unscaled (scaling them by n_sensors / n_used diverged in
    the reference's runs).  Unlike the JAX package (design.py:162), a draw
    with finite gradients and a non-finite loss is redrawn too.

    Returns (value_sum, grad_sum, used): ``used`` a bool a sensor,
    grad_sum None when no sensor survived.
    """
    val, g = None, None
    used = []
    for si, fn in enumerate(grad_fns):
        ok = False
        for r in range(1 + retries):
            # strides far above any iteration count decorrelate a redraw
            # from the base seed and from the other steps' seeds
            s = seed if r == 0 else seed + 1000003 * r + 7919 * si
            v, gi = fn(p, s)
            ok = _all_finite(v, gi)
            if ok:
                break
        used.append(ok)
        if not ok:
            continue
        if g is None:
            val, g = v, gi
        else:
            val = val + v
            g = {k: g[k] + gi[k] for k in g}
    return val, g, used


def value_and_grad(fn):
    """``fn(p, seed) -> scalar`` as ``(p, seed) -> (value, {key:
    gradient})``, each parameter a fresh leaf; a parameter the value does
    not reach gets a zero gradient."""
    def run(p, seed):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        v = fn(leaves, seed)
        gs = torch.autograd.grad(v, list(leaves.values()), allow_unused=True)
        return v.detach(), {k: torch.zeros_like(leaves[k]) if gk is None
                            else gk for k, gk in zip(leaves, gs)}
    return run


class DesignProblem:
    """End-to-end lens optimization (design_problem.py:280-654).  Runs on
    the device of the lens system's tensors."""

    def __init__(self, lens_system: LensSystem, resolution=(64, 64),
                 spp=256, learning_rate=2e-3, iters=50,
                 film_diagonal=35.0, num_sources=1, max_field_angle=5.0,
                 init_camera_z=0.9, loss_scale=1e4, seed=0,
                 sensor_fov=45.0, spectral=None, grad_retries=2):
        self.lens_system = lens_system
        self.device = lens_system.device
        self.resolution = resolution
        self.spp = spp
        self.lr = learning_rate
        self.iters = iters
        self.film_diagonal = film_diagonal
        self.num_sources = num_sources
        self.max_field_angle = max_field_angle
        self.init_camera_z = init_camera_z
        self.loss_scale = loss_scale
        self.seed = seed
        self.sensor_fov = sensor_fov
        # spectral light tracing is on when the lens has glass, so that
        # the Abbe numbers reach the loss through the chromatic spot
        self.spectral = (any(not m.is_air for m in lens_system.materials)
                         if spectral is None else bool(spectral))
        self.loss_history = []
        self.grad_retries = grad_retries
        self.sensor_drops = []
        self.skipped_steps = 0   # steps whose gradients were not finite

    # ------------------------------------------------------------ scene

    def _film_plane_mesh(self):
        """The white screen at z = 0 (design_problem.py:382-396)."""
        m = tf.scale([self.film_diagonal, self.film_diagonal, 1.0])
        return Mesh.make(*rectangle(m), bsdf_index=1, id="film_plane",
                         device=self.device)

    def _sources(self):
        """Evenly spaced field angles aimed at the entrance pupil
        (FieldSource.createSourceArray, design_problem.py:143-182): every
        source's chief ray passes the aperture stop's centre; the distance
        keeps neighbouring disks apart (1.1 r / tan(dtheta / 2))."""
        ls = self.lens_system
        radius = float(ls.front_radial_extent)
        z_entrance = float(ls.compute_pupils()[1])
        pupil = np.array([0.0, 0.0, z_entrance], np.float32)
        if self.num_sources > 1:
            angles = list(np.linspace(0.0, self.max_field_angle,
                                      self.num_sources))
            dtheta = np.deg2rad(self.max_field_angle) / (self.num_sources - 1)
            dist = 1.1 * radius / np.tan(0.5 * dtheta)
        else:
            angles = [0.0]
            dist = max(10.0, 1.1 * float(ls.front_z))
        srcs = []
        for k, ang in enumerate(angles):
            th = np.deg2rad(ang)
            origin = pupil + dist * np.array([np.sin(th), 0.0, np.cos(th)],
                                             np.float32)
            srcs.append(FieldSource(
                name=str(k), origin=origin, target=pupil, radius=radius,
                resolution=self.resolution, fov=self.sensor_fov,
                init_camera_z=self.init_camera_z))
        return srcs

    def build(self):
        """The lens meshes, the geometric tracer, the sources and their
        sensors, and the render scene; returns self."""
        ls, dev = self.lens_system, self.device
        base_bsdfs = [SmoothDiffuse(reflectance=ConstantTexture(
                          torch.zeros(3, device=dev))),
                      SmoothDiffuse(reflectance=ConstantTexture(
                          torch.ones(3, device=dev)))]
        lens_meshes, lens_bsdfs, self.templates = ls.build_elements(
            bsdf_offset=2)
        self.n_base_meshes = 1   # the film plane comes before the lenses
        film_plane = self._film_plane_mesh()

        # the geometric tracer's scene (design_problem.py:416)
        dummy = PerspectiveCamera(to_world=torch.eye(4, device=dev))
        self.geo_scene = make_scene([film_plane] + lens_meshes,
                                    base_bsdfs + lens_bsdfs, [], dummy, dev)
        trace_depth = ls.size() + 1
        geo_integ = PRBBasicIntegrator(max_depth=trace_depth + 2)
        self.geo_tracer = lambda ray: geo_integ.trace(self.geo_scene, ray,
                                                      trace_depth)

        # the render scene: film plane, lenses and sources; one sensor a
        # source, swapped in by scene_for
        self.sources = self._sources()
        src_meshes, emitters = [], []
        for s in self.sources:
            mesh, em = s.source_mesh_emitter(len(emitters), dev)
            src_meshes.append(mesh)
            emitters.append(em)
        self.sensors = [s.make_sensor(self.geo_tracer, ls, dev)
                        for s in self.sources]
        self.base_scene = make_scene(
            [film_plane] + lens_meshes + src_meshes, base_bsdfs + lens_bsdfs,
            emitters, self.sensors[0], dev)
        self.integrator = ParticleTracerIntegrator(
            max_depth=ls.size() + 2, rr_depth=64, spectral=self.spectral)
        return self

    # ------------------------------------------------------- optimization

    def params(self):
        """The differentiable parameters (``LensSystem.params``)."""
        return self.lens_system.params()

    def apply_params(self, p):
        """The lens system with the parameters of ``p``
        (``LensSystem.with_params``)."""
        return self.lens_system.with_params(p)

    def scene_for(self, p, sensor_index):
        """(the render scene of ``p`` watched by sensor ``sensor_index``,
        its lens system)."""
        ls = self.apply_params(p)
        scene = self.base_scene
        meshes = ls.remesh(list(scene.meshes), self.templates,
                           mesh_offset=self.n_base_meshes)
        bsdfs = ls.update_bsdfs(list(scene.bsdfs), bsdf_offset=2)
        return dataclasses.replace(
            scene, meshes=tuple(meshes), bsdfs=tuple(bsdfs),
            sensor=self.sensors[sensor_index]), ls

    def sensor_loss(self, p, seed, sensor_index):
        """loss_scale times the RMS spot of sensor ``sensor_index``."""
        scene, _ = self.scene_for(p, sensor_index)
        img = render(scene, self.integrator, seed, self.spp,
                     device=self.device)
        return self.loss_scale * rms_loss(img)

    def loss(self, p, seed):
        """The mean of the sensors' losses."""
        n = len(self.sensors)
        return sum(self.sensor_loss(p, seed, si) for si in range(n)) / n

    def optimize(self, fixed_efl=None, verbose=False, lr_overrides=None,
                 callback=None, train_keys=None, checkpoint_path=None,
                 checkpoint_every=10):
        """The Adam loop (design_problem.py:495-586); returns the final
        parameters.

        ``fixed_efl``: solve the rear surface's (c, z0) at every step to
        hold this EFL (ConstrainedEFLProblem, :656).  ``lr_overrides``:
        per-parameter learning rates.  ``callback(iter, params, loss)``
        after each step.  ``train_keys``: optimize only these parameters,
        the others frozen constants.  ``checkpoint_path``: resumable via
        ``utils/elastic.CheckpointedLoop`` (every ``checkpoint_every``
        steps; seeds derive from the step, so a resumed run follows the
        same trajectory).  Each sensor's gradient is taken on its own and
        the gradients summed (``accumulate_sensor_grads``), whatever the
        number of sensors."""
        p = self.params()
        if fixed_efl is not None:
            p.pop("lens0_c", None)
            p.pop("lens0_z0", None)
        frozen = {}
        if train_keys is not None:
            missing = set(train_keys) - set(p)
            if missing:
                raise KeyError(f"unknown train_keys: {sorted(missing)}")
            frozen = {k: v.detach() for k, v in p.items()
                      if k not in train_keys}
            p = {k: p[k] for k in train_keys}

        def full_params(p):
            p = {**frozen, **p}
            if fixed_efl is not None:
                rear = self.apply_params(p).rear_surface_params_for_EFL(
                    fixed_efl)
                p = {**p, "lens0_c": rear["c"], "lens0_z0": rear["z0"]}
            return p

        n_sens = len(self.sensors)
        self.sensor_drops = [0] * n_sens
        grad_fns = [value_and_grad(
            lambda p, seed, si=si: self.sensor_loss(
                full_params(p), seed, si) / n_sens)
            for si in range(n_sens)]

        def grad_fn(p, seed):
            val, g, used = accumulate_sensor_grads(
                grad_fns, p, seed, retries=self.grad_retries)
            for si, u in enumerate(used):
                self.sensor_drops[si] += not u
            if g is None or sum(used) < max(1, (2 * n_sens + 2) // 3):
                nan = torch.tensor(float("nan"), device=self.device)
                return nan, {k: torch.full_like(v, float("nan"))
                             for k, v in p.items()}
            return val, g

        opt = Adam(lr=self.lr)
        if lr_overrides:
            opt.set_learning_rate(lr_overrides)
        p = {k: v.detach() for k, v in p.items()}
        state = opt.init(p)
        start, loop = 0, None
        if checkpoint_path is not None:
            loop = CheckpointedLoop(checkpoint_path, every=checkpoint_every)
            drops = {"sensor_drops": np.zeros(n_sens, np.int64)}
            p, state, start = loop.resume(p, state, extra=drops)
            if loop.extra:
                self.sensor_drops = [int(x) for x in
                                     loop.extra["sensor_drops"]]

        for it in range(start, self.iters):
            val, g = grad_fn(p, self.seed + it)
            # one pathological lane can poison the whole gradient:
            # skipping the step redraws with the next seed
            p, state, ok = nan_guard_step(opt, p, g, state)
            self.skipped_steps += not ok
            self.loss_history.append(float(val))
            if loop is not None:
                loop.maybe_save(it, p, state, metric=float(val), extra={
                    "sensor_drops": np.asarray(self.sensor_drops, np.int64)})
            if callback is not None:
                callback(it, p, float(val))
            if verbose:
                print(f"iter {it:3d}: loss = {float(val):.5f}"
                      + ("" if ok else "  [step skipped: non-finite]"))
        if fixed_efl is not None:
            rear = self.apply_params({**frozen, **p}) \
                .rear_surface_params_for_EFL(fixed_efl)
            p = {**p, "lens0_c": rear["c"], "lens0_z0": rear["z0"]}
        self.final_params = p
        self.lens_system = self.apply_params(p)
        return p
