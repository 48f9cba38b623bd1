"""Mesh-based optimizable lens system (mitsuba_tpu/lens/lens_system.py;
reference lens_design/lens.py:252-1333 of the fork).

``LensMaterial`` is a glass of differentiable (n_d, Abbe number);
``LensSystem`` orders the surfaces from the film to the world and gives
the paraxial ray-transfer analysis (EFL, BFL, FFL, the pupils,
lens.py:752-968) and the rear surface that holds a fixed EFL
(lens.py:1023).  ``build_elements`` makes the meshes and dispersive
BSDFs once, on fixed (x, y) templates; ``remesh`` re-evaluates the sag at
the templates from the current (differentiable) surface parameters, and
``update_bsdfs`` the interfaces from the current glasses: the scene's
BVH is refitted to the new vertices at the next render.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.bsdfs import DispersiveDielectric, SmoothDiffuse
from ..models.shapes import Mesh
from ..models.textures import ConstantTexture
from .geometry import create_surface_geometry
from .surfaces import as_param


@dataclass
class LensMaterial:
    ior: torch.Tensor    # () n_d, differentiable (lens.py:252)
    V_d: torch.Tensor    # () Abbe number
    name: str = "air"

    @staticmethod
    def create(name="air", ior=1.000277, V_d=0.0):
        """A glass of CPU tensors; ``LensSystem.create`` moves them to its
        surfaces' device."""
        return LensMaterial(ior=as_param(ior), V_d=as_param(V_d), name=name)

    @property
    def is_air(self):
        return self.name == "air"


def _sag_normals(surface, xy):
    """Unit vertex normals from the sag's gradient, n ∝ (dz/dx, dz/dy, -1),
    facing the film (-z) as the flipped winding does.  Smooth shading
    normals make a coarse lens mesh optically exact.  The gradient is
    autograd's with ``create_graph``, so the normals stay in the graph of
    the surface's parameters (``jax.vmap(jax.grad(sag))`` in the JAX
    package)."""
    with torch.enable_grad():
        p = xy.detach().requires_grad_(True)
        g = torch.autograd.grad(surface.sag(p[:, 0], p[:, 1]).sum(), p,
                                create_graph=True)[0]
    if not any(v.requires_grad for v in surface.params.values()):
        g = g.detach()
    n = torch.cat([g, -torch.ones((xy.shape[0], 1), device=xy.device)], -1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def _mat2(a, b, c, d):
    """The 2 x 2 matrix [[a, b], [c, d]] of scalar tensors."""
    return torch.stack([torch.stack([a, b]), torch.stack([c, d])])


@dataclass
class LensSystem:
    surfaces: tuple        # film -> world order (rear first)
    materials: tuple       # len(surfaces) + 1; materials[0] is air
    aperture_index: int = -1
    n_rings: int = 12
    n_sectors: int = 24
    baffle_scale: float = 1.1

    @staticmethod
    def create(surfaces, materials, aperture_index=None, n_rings=12,
               n_sectors=24):
        """``materials``: the glass of each gap, len(surfaces) - 1 of them
        (lens.py:769 prepends the film side's air); they move to the
        surfaces' device."""
        dev = surfaces[0].z0.device
        mats = tuple(dataclasses.replace(m, ior=m.ior.to(dev),
                                         V_d=m.V_d.to(dev))
                     for m in (LensMaterial.create(),) + tuple(materials))
        if aperture_index is None or aperture_index < 0:
            aperture_index = -1
        return LensSystem(surfaces=tuple(surfaces), materials=mats,
                          aperture_index=aperture_index, n_rings=n_rings,
                          n_sectors=n_sectors)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def params(self):
        """The differentiable parameters by name: each surface's shape
        parameters (``lens{i}_{c, K, z0, ai}``) and each glass's
        ``mat_{name}_ior`` and ``mat_{name}_V_d``
        (LensSystem.add_to_optimizer)."""
        p = {}
        for i, s in enumerate(self.surfaces):
            for k, v in s.params.items():
                p[f"lens{i}_{k}"] = v
        for m in self.materials:
            if not m.is_air:
                p[f"mat_{m.name}_ior"] = m.ior
                p[f"mat_{m.name}_V_d"] = m.V_d
        return p

    def with_params(self, p):
        """The system with the parameters named in ``p`` (``params``'
        names) replaced, the graph of ``p``'s tensors kept; a name ``p``
        lacks keeps its value."""
        surfaces = tuple(
            s.with_params({k: p[f"lens{i}_{k}"] for k in s.params
                           if f"lens{i}_{k}" in p})
            for i, s in enumerate(self.surfaces))
        materials = tuple(
            m if m.is_air or f"mat_{m.name}_ior" not in p
            else dataclasses.replace(m, ior=p[f"mat_{m.name}_ior"],
                                     V_d=p[f"mat_{m.name}_V_d"])
            for m in self.materials)
        return self.replace(surfaces=surfaces, materials=materials)

    @property
    def device(self):
        return self.surfaces[0].z0.device

    @property
    def rear_z(self):
        return self.surfaces[0].z0

    @property
    def front_z(self):
        return self.surfaces[-1].z0

    @property
    def front_radial_extent(self):
        return self.surfaces[-1].radial_extent

    def size(self):
        n = len(self.surfaces)
        return n - 1 if self.aperture_index >= 0 else n

    def _mat(self, i):
        """The glass film-side of surface i (cyclic, as the reference: the
        world side of the last surface is air)."""
        return self.materials[i % len(self.materials)]

    def _stop(self):
        return (self.aperture_index if self.aperture_index >= 0
                else len(self.surfaces) - 1)

    # ------------------------------------------------- paraxial analysis

    def _elem_matrices(self, idx):
        """(refraction, transfer) matrices of surface ``idx`` on the
        paraxial state (y, u) (lens.py:810-840)."""
        one = torch.ones((), device=self.device)
        zero = torch.zeros((), device=self.device)
        z_prev = zero if idx == 0 else self.surfaces[idx - 1].z0
        thickness = self.surfaces[idx].z0 - z_prev
        curvature = -self.surfaces[idx].curvature()
        ior_i = self._mat(idx).ior
        ior_f = self._mat(idx + 1).ior
        lens_m = _mat2(one, zero, -(ior_f - ior_i) * curvature / ior_f,
                       ior_i / ior_f)
        return lens_m, _mat2(one, thickness, zero, one)

    def paraxial_matrices(self):
        """(M_film2front, M_rear2front, M_film2ap, M_ap2front)
        (lens.py:810-884 compute_paraxial_quantities)."""
        eye = torch.eye(2, device=self.device)
        M_f2f = M_r2f = M_f2a = M_a2f = eye
        ap = self._stop()
        for idx in range(len(self.surfaces)):
            lens_m, transit = self._elem_matrices(idx)
            elem = lens_m @ transit
            M_f2f = elem @ M_f2f
            if idx < ap:
                M_f2a = elem @ M_f2a
            elif idx == ap:
                M_f2a = transit @ M_f2a
                M_a2f = lens_m @ M_a2f
            else:
                M_a2f = elem @ M_a2f
            M_r2f = (lens_m if idx == 0 else elem) @ M_r2f
        return M_f2f, M_r2f, M_f2a, M_a2f

    def compute_EFL(self):
        M = self.paraxial_matrices()[1]
        return -1.0 / M[1, 0]

    def compute_BFL(self):
        M = self.paraxial_matrices()[1]
        return -M[1, 1] / M[1, 0]

    def compute_FFL(self):
        M = self.paraxial_matrices()[1]
        return -M[0, 0] / M[1, 0]

    def compute_pupils(self):
        """(z_exit, z_entrance, r_exit, r_entrance) (lens.py:932-968)."""
        _, _, M_rear, M_front = self.paraxial_matrices()
        z_exit = M_rear[0, 1] / M_rear[0, 0]
        z_entrance = self.front_z - M_front[0, 1] / M_front[1, 1]
        ap_radius = self.surfaces[self._stop()].radial_extent
        return (z_exit, z_entrance, ap_radius / M_rear[0, 0],
                ap_radius / M_front[1, 1])

    def trace_paraxial_front2film(self, yu):
        """The paraxial state (y, u) traced from the front to the film."""
        M = self.paraxial_matrices()[0]
        det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
        inv = _mat2(M[1, 1], -M[0, 1], -M[1, 0], M[0, 0]) / det
        return inv @ yu

    def get_EFL_paraxial_matrix(self):
        """The matrix from surface 1 (the rear skipped) to the front
        (lens.py:888-918), which the fixed-EFL constraint solves with."""
        M = torch.eye(2, device=self.device)
        for idx in range(1, len(self.surfaces)):
            lens_m, transit = self._elem_matrices(idx)
            M = (lens_m if idx == 1 else lens_m @ transit) @ M
        return M

    def rear_surface_params_for_EFL(self, f):
        """The rear surface's (c, z0) that make EFL == f with the focus on
        the film plane (lens.py:1023 get_rear_surface_params)."""
        Mk = self.get_EFL_paraxial_matrix()
        C, D = Mk[1, 0], Mk[1, 1]
        k = self._mat(0).ior / self._mat(1).ior
        z2 = self.surfaces[1].z0
        surf_z0 = f * k * (C * z2 + D) / (1.0 + f * k * C)
        surf_c = -(1.0 / f + C) / ((C * (z2 - surf_z0) + D) * (1.0 - k))
        return {"c": surf_c * self.surfaces[0].radial_extent, "z0": surf_z0}

    # ------------------------------------------------------ scene meshes

    def _interface(self, i):
        ext, inte = self._mat(i), self._mat(i + 1)
        return DispersiveDielectric(int_ior_d=inte.ior, int_V_d=inte.V_d,
                                    ext_ior_d=ext.ior, ext_V_d=ext.V_d)

    def build_elements(self, bsdf_offset: int = 0):
        """(meshes, bsdfs, templates) on the surfaces' device: a lens mesh
        and a baffle per refracting surface (the aperture a baffle only);
        BSDF 0 the black baffles', then each refracting surface's
        dispersive interface, exterior the film-side glass (lens.py:343,
        425); ``templates`` (mesh index, (x, y) template, surface index)
        for ``remesh``."""
        dev = self.device
        meshes, templates = [], []
        bsdfs = [SmoothDiffuse(reflectance=ConstantTexture(
            torch.zeros(3, device=dev)))]
        black_idx = bsdf_offset
        for i, s in enumerate(self.surfaces):
            def sag_np(x, y, s=s):
                with torch.no_grad():
                    return s.sag(torch.as_tensor(x, device=dev),
                                 torch.as_tensor(y, device=dev)).cpu().numpy()

            V, F, Vb, Fb = create_surface_geometry(
                self.n_rings, self.n_sectors, s.radial_extent, sag_np,
                baffle_radius=self.baffle_scale * s.radial_extent,
                flip_normals=True)   # normals face the film (lens.py:783)
            if i == self.aperture_index:
                meshes.append(Mesh.make(Vb, Fb, bsdf_index=black_idx,
                                        id=f"aperture{i}", device=dev))
                continue
            bsdfs.append(self._interface(i))
            xy = torch.tensor(np.ascontiguousarray(V[:, :2]), device=dev)
            mesh = Mesh.make(V, F, bsdf_index=bsdf_offset + len(bsdfs) - 1,
                             id=f"lens{i}", device=dev)
            templates.append((len(meshes), xy, i))
            meshes.append(dataclasses.replace(mesh,
                                              normals=_sag_normals(s, xy)))
            meshes.append(Mesh.make(Vb, Fb, bsdf_index=black_idx,
                                    id=f"baffle{i}", device=dev))
        return meshes, bsdfs, templates

    def remesh(self, meshes, templates, mesh_offset: int = 0):
        """The mesh list with each lens mesh's z and normals re-evaluated
        at its template from the current surface parameters (lens.py:509
        update()); each baffle, right after its lens mesh, follows its
        surface's rim z."""
        out = list(meshes)
        for mesh_idx, xy, si in templates:
            s = self.surfaces[si]
            z = s.sag(xy[:, 0], xy[:, 1])
            i = mesh_offset + mesh_idx
            out[i] = dataclasses.replace(
                out[i], vertices=torch.cat([xy, z[:, None]], -1),
                normals=_sag_normals(s, xy))
            rim = torch.tensor([s.radial_extent, 0.0], device=xy.device)
            rim_z = s.sag(rim[0], rim[1])
            bv = out[i + 1].vertices
            out[i + 1] = dataclasses.replace(out[i + 1], vertices=torch.cat(
                [bv[:, :2], rim_z.expand(bv.shape[0], 1)], -1))
        return out

    def update_bsdfs(self, bsdfs, bsdf_offset: int = 0):
        """The BSDF list with each interface made again from the current
        (differentiable) glasses (lens.py LensElement.update)."""
        out = list(bsdfs)
        j = bsdf_offset + 1   # past the baffles' black BSDF
        for i in range(len(self.surfaces)):
            if i != self.aperture_index:
                out[j] = self._interface(i)
                j += 1
        return out
