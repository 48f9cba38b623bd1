"""The realistic multi-element lens camera (mitsuba_tpu/lens/camera.py;
reference src/sensors/realisticlens.cpp:825-2420): sequential surface
tracing from the film to the world and back, exit-pupil table sampling,
thick-lens autofocus by cardinal points, and the connection to the
sensor that the particle tracer makes.

The interfaces are a tuple, so a trace is a Python loop over them, each
a batch of eager PyTorch operations over the lanes (plain XLA in the JAX
package; neither has a kernel of its own).  A lane that an interface
does not transmit keeps the ray it had before it (``records.select``)
and is dead from there on; ``sample_ray`` gives it weight 0.

Conventions, as the reference's:

- camera space: the film plane at z = 0 spans [-hx, hx] x [-hy, hy],
  the optical axis +z points to the scene, the interfaces lie at z > 0;
- a film sample (u, v) in [0, 1)^2 is the film point ((2u - 1) hx,
  (2v - 1) hy): the lens inverts the image, so the picture is upright
  as the perspective camera's is;
- ``diagonal``, the film's physical diagonal in metres, sets hx and hy
  (film.h:193 get_physical_size).

The build-time traces (autofocus) run on the host whatever the camera's
device, so a camera built for the GPU has the bits of one built for the
CPU; the exit-pupil table is traced on the camera's device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import qmc
from ..core import transform as tf
from ..core.math import dot, normalize, sqr
from ..core.records import DirectionSample, Ray, select
from ..core.spectrum import rgb_response_flat, sample_wavelength_visible
from ..core.warp import square_to_uniform_disk_concentric
from ..device import resolve_device
from ..models.film import Film
from ..models.samplers import IndependentSampler
from .designs import build_design
from .elements import offset_element

INF = math.inf
NOMINAL_LAMBDA_NM = 589.3
# rays of the exit-pupil table traced in one batch: the default table's
# 64 x 65,536 at once
LUT_BATCH_RAYS = 1 << 22


def film_half_extents(diagonal, width, height):
    """The film's physical half-extents (hx, hy) from its diagonal
    (film.h:193)."""
    aspect = height / width
    x = float(np.sqrt(diagonal ** 2 / (1.0 + aspect ** 2)))
    return x / 2.0, aspect * x / 2.0


def _trace(interfaces, ray, active):
    """The rays through ``interfaces`` in order, dead lanes parked."""
    if active is None:
        active = torch.ones(ray.o.shape[:-1], dtype=torch.bool,
                            device=ray.o.device)
    for iface in interfaces:
        nxt, ok = iface.compute_interaction(ray, active)
        ray = select(ok, nxt, ray)
        active = active & ok
    return ray, active


def _moved(obj, device):
    """A copy of the dataclass tree ``obj`` with every tensor detached on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device)
    if isinstance(obj, tuple):
        return tuple(_moved(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _moved(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    return obj


@dataclass
class RealisticLensCamera:
    interfaces: tuple                 # rear (film side) -> front (world)
    to_world: torch.Tensor            # (4, 4)
    pupil_min: torch.Tensor           # (S, 2) exit-pupil box minima
    pupil_max: torch.Tensor           # (S, 2)
    film_z_position: torch.Tensor     # () hypercentric film offset
    film: Film = field(default_factory=Film)
    sampler: IndependentSampler = field(default_factory=IndependentSampler)
    diagonal: float = 0.035           # the film's physical diagonal (m)
    near_clip: float = 1e-2
    far_clip: float = 1e4
    sample_exit_pupil: bool = False
    spectral: bool = False
    shutter_open_time: float = 1.0
    id: str = "realisticlens"

    needs_aperture_sample = True

    # ------------------------------------------------------------ helpers

    @property
    def device(self):
        return self.to_world.device

    @property
    def rear_z(self):
        return self.interfaces[0].z_intercept

    @property
    def rear_radius(self):
        return self.interfaces[0].element_radius

    def _half_extents(self):
        return film_half_extents(self.diagonal, self.film.width,
                                 self.film.height)

    def film_diagonal_half(self):
        hx, hy = self._half_extents()
        return float(np.sqrt(hx * hx + hy * hy))

    # ------------------------------------------------------------ tracing

    def trace_ray_from_film(self, ray: Ray, active=None):
        """Sequential surface trace, rear -> front (realisticlens.cpp:1654):
        (the rays out of the front element, alive)."""
        return _trace(self.interfaces, ray, active)

    def trace_ray_from_world(self, ray: Ray, active=None):
        """The reverse trace, front -> rear (realisticlens.cpp:1960)."""
        return _trace(reversed(self.interfaces), ray, active)

    # ----------------------------------------------------------- sampling

    def sample_wavelengths(self, wavelength_sample):
        """(hero wavelength (N, 1) nm, or None for an RGB camera; RGB
        response weight (N, 3))."""
        if not self.spectral:
            return None, torch.ones((wavelength_sample.shape[0], 3),
                                    device=wavelength_sample.device)
        lam, pdf = sample_wavelength_visible(wavelength_sample)
        weight = rgb_response_flat(lam) / torch.clamp(pdf, min=1e-12)[..., None]
        return lam[..., None], weight

    def _sample_exit_pupil(self, film_p, aperture_sample):
        """A point of the film point's radial segment's exit-pupil box,
        rotated to the film point's azimuth (realisticlens.cpp:1812):
        (point on the rear plane (N, 3), the box's area (N,))."""
        n_seg = self.pupil_min.shape[0]
        r_film = torch.sqrt(sqr(film_p[..., 0]) + sqr(film_p[..., 1]))
        idx = torch.clamp(torch.floor(
            r_film / self.film_diagonal_half() * n_seg).to(torch.int64),
            0, n_seg - 1)
        mn = self.pupil_min[idx]
        mx = self.pupil_max[idx]
        ext = mx - mn
        area = ext[..., 0] * ext[..., 1]
        p = mn + ext * aperture_sample
        safe = r_film > 0.0
        inv_r = torch.where(safe, 1.0 / torch.clamp(r_film, min=1e-20), 0.0)
        sin_t = torch.where(safe, film_p[..., 1] * inv_r, 0.0)
        cos_t = torch.where(safe, film_p[..., 0] * inv_r, 1.0)
        p_rear = torch.stack([cos_t * p[..., 0] - sin_t * p[..., 1],
                              sin_t * p[..., 0] + cos_t * p[..., 1],
                              self.rear_z.expand(r_film.shape)], dim=-1)
        return p_rear, area

    def _sample_rear_element(self, aperture_sample):
        """A uniform point of the rear element's disk
        (realisticlens.cpp:1870): (point (N, 3), the disk's area (N,))."""
        p2 = self.rear_radius * square_to_uniform_disk_concentric(
            aperture_sample)
        n = p2.shape[:-1]
        area = math.pi * sqr(self.rear_radius)
        return (torch.cat([p2, self.rear_z.expand(n + (1,))], dim=-1),
                area.expand(n))

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample):
        """Film sample -> pupil -> lens trace -> world ray
        (realisticlens.cpp:2209-2292): (Ray, importance weight (N, 3)),
        weight 0 where the lens does not transmit the ray.  ``time`` is
        not used: the port's rays carry none."""
        n = position_sample.shape[0]
        dev = position_sample.device
        wavelengths, weight = self.sample_wavelengths(wavelength_sample)
        hx, hy = self._half_extents()
        film_p = torch.stack([(2.0 * position_sample[..., 0] - 1.0) * hx,
                              (2.0 * position_sample[..., 1] - 1.0) * hy,
                              torch.zeros(n, device=dev)], dim=-1)
        if self.sample_exit_pupil:
            aperture_p, bounds_area = self._sample_exit_pupil(
                film_p, aperture_sample)
        else:
            aperture_p, bounds_area = self._sample_rear_element(
                aperture_sample)
        ray = Ray(o=film_p, d=normalize(aperture_p - film_p),
                  maxt=torch.full((n,), INF, device=dev),
                  wavelengths=wavelengths)
        out, active = self.trace_ray_from_film(ray)
        d_local = out.d

        # camera -> world, then the near clip
        o = torch.cat([out.o[..., :2],
                       (out.o[..., 2] + self.film_z_position)[..., None]], -1)
        o = tf.apply_point(self.to_world, o)
        d_world = tf.apply_vector(self.to_world, d_local)
        dz = d_local[..., 2]
        inv_z = 1.0 / torch.where(torch.abs(dz) > 1e-12, dz, 1.0)
        o = o + d_world * (self.near_clip * inv_z)[..., None]
        maxt = (self.far_clip - self.near_clip) * inv_z

        if self.sample_exit_pupil:
            w = self.shutter_open_time * bounds_area / torch.clamp(
                sqr(self.rear_z), min=1e-20)
        else:
            w = sqr(sqr(dz))   # cos^4 falloff (realisticlens.cpp:2283)
        weight = weight * torch.where(active, w, 0.0)[..., None]
        return Ray(o=o, d=d_world, maxt=maxt, wavelengths=wavelengths), weight

    def sample_direction(self, ref_p, sample2, active=None):
        """The connection from points ``ref_p`` (N, 3) to the sensor
        (realisticlens.cpp:2301-2394): a uniform point of the front
        element, the reverse trace to the film, (DirectionSample,
        importance (N, 3)), as ``PerspectiveCamera.sample_direction``.
        The reverse trace takes the nominal wavelength, as the JAX
        package's does.  The pose is inverted on the host
        (``transform.inverse``), differentiably."""
        n, dev = ref_p.shape[0], ref_p.device
        if active is None:
            active = torch.ones(n, dtype=torch.bool, device=dev)
        local_ref = tf.apply_point(tf.inverse(self.to_world), ref_p)
        ok = active & (local_ref[..., 2] >= self.near_clip) \
            & (local_ref[..., 2] <= self.far_clip)

        front = self.interfaces[-1]
        front_radius = front.element_radius
        p2 = square_to_uniform_disk_concentric(sample2) * front_radius
        aperture_p = torch.cat([p2, front.z_intercept.expand(n, 1)], dim=-1)
        dir_ap2ref = local_ref - aperture_p
        dist = torch.sqrt(torch.clamp(dot(dir_ap2ref, dir_ap2ref), min=1e-20))
        dir_ap2ref = dir_ap2ref / dist[..., None]

        world_ray = Ray(o=local_ref, d=-dir_ap2ref,
                        maxt=torch.full((n,), INF, device=dev))
        out, traced = self.trace_ray_from_world(world_ray, ok)
        ok = ok & traced

        # the film plane z = 0
        odz = out.d[..., 2]
        t_film = -out.o[..., 2] / torch.where(torch.abs(odz) > 1e-12, odz, 1.0)
        p_film = out.o + out.d * t_film[..., None]
        hx, hy = self._half_extents()
        u = (p_film[..., 0] / hx + 1.0) * 0.5
        v = (p_film[..., 1] / hy + 1.0) * 0.5
        ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)

        normalization = 1.0 / (4.0 * hx * hy)
        ct_film = -odz
        ok = ok & (torch.abs(ct_film) > 1e-6)
        inv_ct = 1.0 / torch.where(ok, ct_film, 1.0)
        value = torch.where(
            ok, normalization * sqr(sqr(inv_ct)) * sqr(self.rear_z), 0.0)
        aperture_pdf = 1.0 / (math.pi * sqr(front_radius))
        ct_ref = dir_ap2ref[..., 2]
        pdf = torch.where(
            ok, aperture_pdf * dist * dist / torch.clamp(ct_ref, min=1e-9),
            0.0)
        p_world = tf.apply_point(self.to_world, aperture_p)
        axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)
        ds = DirectionSample(
            p=p_world, n=tf.apply_vector(self.to_world, axis),
            uv=torch.stack([u * self.film.width, v * self.film.height], -1),
            d=(p_world - ref_p) / dist[..., None], dist=dist, pdf=pdf,
            delta=torch.zeros(n, dtype=torch.bool, device=dev),
            emitter_index=torch.zeros(n, dtype=torch.int64, device=dev))
        imp = (value / (dist * dist) * ct_ref)[..., None]
        return ds, torch.where(ok[..., None], imp, 0.0).expand(n, 3)


# -------------------------------------------------------------- build time

def _paraxial_trace(camera, r, from_world):
    """One paraxial ray at height ``r`` through the lens, on the host:
    (the ray in, the ray out, alive)."""
    ifaces = _moved(camera.interfaces, "cpu")
    end = ifaces[-1] if from_world else ifaces[0]
    o = torch.tensor([[r, 0.0, 0.0]])
    o[0, 2] = end.z_intercept + (1.0 if from_world else -1.0)
    d = torch.tensor([[0.0, 0.0, -1.0 if from_world else 1.0]])
    lam = (torch.full((1, 1), NOMINAL_LAMBDA_NM) if camera.spectral
           else None)
    ray = Ray(o=o, d=d, maxt=torch.full((1,), INF), wavelengths=lam)
    out, active = _trace(reversed(ifaces) if from_world else ifaces, ray,
                         None)
    return ray, out, active


def _cardinal_points(start, end):
    """(principal plane z, focal point z) of a paraxial trace
    (realisticlens.cpp:2107), float32 0-d tensors."""
    t_focus = -end.o[0, 0] / end.d[0, 0]
    z_f = (end.o + end.d * t_focus)[0, 2]
    t_plane = (start.o[0, 0] - end.o[0, 0]) / end.d[0, 0]
    z_p = (end.o + end.d * t_plane)[0, 2]
    return z_p, z_f


def thick_lens_approximation(camera):
    """(back_plane_z, back_focal_length, front_plane_z, front_focal_length,
    both traces alive) (realisticlens.cpp:2115)."""
    hx, _ = camera._half_extents()
    r = 0.001 * 2.0 * hx
    start_w, end_w, ok_w = _paraxial_trace(camera, r, from_world=True)
    p_img, f_img_pt = _cardinal_points(start_w, end_w)
    start_f, end_f, ok_f = _paraxial_trace(camera, r, from_world=False)
    p_obj, f_obj_pt = _cardinal_points(start_f, end_f)
    return (float(p_img), float(p_img - f_img_pt), float(p_obj),
            float(f_obj_pt - p_obj), bool(ok_w[0]) and bool(ok_f[0]))


def focus_thick_lens(camera, focus_distance):
    """The axial shift that focuses the lens at ``focus_distance``
    (realisticlens.cpp:2161); 0 where the thick-lens model fails."""
    p_img, f_img, p_obj, _, ok = thick_lens_approximation(camera)
    if not ok or not np.isfinite(f_img):
        return 0.0
    tmp = max(focus_distance, 4.01 * f_img) - p_obj
    disc = (p_img + tmp) ** 2 - 4.0 * f_img * (p_img + tmp)
    if disc < 0:
        return 0.0
    delta = 0.5 * (p_img - tmp + np.sqrt(disc))
    return float(delta) if np.isfinite(delta) else 0.0


def compute_exit_pupil_lut(camera, n_segments: int = 64,
                           rays_per_segment: int = 1 << 18):
    """The exit pupil's bounding box for each radial film segment
    (realisticlens.cpp:1685-1809): QMC rays from the segment's film
    points to a square around the rear element, traced film -> world on
    the camera's device; the box of the transmitted rays' rear-plane
    points, padded by the points' spacing (the whole square where none
    passes).  Segments are traced together, ``LUT_BATCH_RAYS`` rays at
    most at a time.  Returns (pupil_min, pupil_max), (S, 2) each."""
    dev = camera.device
    rear_radius = float(camera.rear_radius) * 1.5
    rear_z = float(camera.rear_z)
    diag = camera.film_diagonal_half()
    n = rays_per_segment
    i = torch.arange(n, dtype=torch.int64, device=dev)
    px = -rear_radius + 2.0 * rear_radius * qmc.radical_inverse_2(i)
    py = -rear_radius + 2.0 * rear_radius * qmc.radical_inverse(3, i)
    pts = torch.stack([px, py], dim=-1)
    p_rear = torch.stack([px, py, torch.full_like(px, rear_z)], dim=-1)
    lam = None
    if camera.spectral:
        lam = (380.0 + (700.0 - 380.0) * qmc.radical_inverse(5, i))[:, None]
    i_f = i.to(torch.float32) + 0.5
    spacing = 4.0 * rear_radius * np.sqrt(2.0 / n)
    whole = torch.tensor([rear_radius, rear_radius], dtype=torch.float32,
                         device=dev)
    per = max(1, LUT_BATCH_RAYS // n)
    mins, maxs = [], []
    with torch.no_grad():
        for s0 in range(0, n_segments, per):
            segs = range(s0, min(s0 + per, n_segments))
            r0 = torch.tensor([s * diag / n_segments for s in segs],
                              dtype=torch.float32, device=dev)[:, None]
            r1 = torch.tensor([(s + 1) * diag / n_segments for s in segs],
                              dtype=torch.float32, device=dev)[:, None]
            x_film = r0 + (r1 - r0) * i_f / n                   # (k, n)
            zero = torch.zeros_like(x_film)
            p_film = torch.stack([x_film, zero, zero], dim=-1)
            d = normalize(p_rear - p_film).reshape(-1, 3)
            k = len(segs)
            ray = Ray(o=p_film.reshape(-1, 3), d=d,
                      maxt=torch.full((k * n,), INF, device=dev),
                      wavelengths=None if lam is None else lam.repeat(k, 1))
            _, ok = camera.trace_ray_from_film(ray)
            ok = ok.reshape(k, n, 1)
            mn = torch.where(ok, pts, 1e9).amin(dim=1)
            mx = torch.where(ok, pts, -1e9).amax(dim=1)
            none = ~ok.any(dim=1)
            mins.append(torch.where(none, -whole, mn) - spacing)
            maxs.append(torch.where(none, whole, mx) + spacing)
    return torch.cat(mins), torch.cat(maxs)


def make_lens_camera(lens_design: str = "singlet", to_world=None,
                     film: Film | None = None, sampler=None,
                     diagonal: float = 0.035, focus_distance: float = 6.0,
                     sample_exit_pupil: bool = False, spectral: bool = False,
                     near_clip: float = 1e-2, far_clip: float = 1e4,
                     pupil_segments: int = 64,
                     pupil_rays_per_segment: int = 1 << 16, device=None,
                     **design_kw):
    """A RealisticLensCamera of the named design, built, autofocused at
    ``focus_distance`` and, with ``sample_exit_pupil``, given its
    exit-pupil table (the constructor's flow, realisticlens.cpp:832-933),
    on ``device`` (default: the GPU, raising without one)."""
    device = resolve_device(device)
    film = film or Film()
    sampler = sampler or IndependentSampler()
    to_world = (torch.eye(4) if to_world is None
                else torch.as_tensor(to_world, dtype=torch.float32))
    interfaces, film_z, fine_focus = build_design(lens_design, device=device,
                                                  **design_kw)
    cam = RealisticLensCamera(
        interfaces=interfaces, to_world=to_world.to(device),
        pupil_min=torch.zeros((pupil_segments, 2), device=device),
        pupil_max=torch.zeros((pupil_segments, 2), device=device),
        film_z_position=torch.tensor(film_z, dtype=torch.float32,
                                     device=device),
        film=film, sampler=sampler, diagonal=diagonal, near_clip=near_clip,
        far_clip=far_clip, sample_exit_pupil=sample_exit_pupil,
        spectral=spectral)
    if fine_focus:
        delta = focus_thick_lens(cam, focus_distance)
        cam = dataclasses.replace(cam, interfaces=tuple(
            offset_element(e, -delta) for e in cam.interfaces))
    if sample_exit_pupil:
        mn, mx = compute_exit_pupil_lut(
            cam, n_segments=pupil_segments,
            rays_per_segment=pupil_rays_per_segment)
        cam = dataclasses.replace(cam, pupil_min=mn, pupil_max=mx)
    return cam


def make_realistic_lens_camera(d: dict, film, sampler, device=None):
    """The scene loader's hook for a ``realisticlens`` sensor dict."""
    w = d.get("to_world")
    return make_lens_camera(
        lens_design=d.get("lens_design", "singlet"),
        to_world=None if w is None else np.asarray(w, np.float32),
        film=film, sampler=sampler,
        diagonal=0.001 * float(d.get("diagonal_mm", 35.0)),
        focus_distance=float(d.get("object_distance", 6.0)),
        sample_exit_pupil=bool(d.get("sample_exit_pupil", False)),
        spectral=bool(d.get("spectral", False)),
        near_clip=float(d.get("near_clip", 1e-2)),
        far_clip=float(d.get("far_clip", 1e4)),
        device=device,
        object_distance=float(d.get("object_distance", 6.0)),
        lens_focal_length=float(d.get("lens_focal_length", 0.05)),
        lens_diameter=float(d.get("lens_diameter", 0.01)),
        ap_size=float(d.get("ap_size", 1.0)),
        ap_offset=float(d.get("ap_offset", 2.0)))
