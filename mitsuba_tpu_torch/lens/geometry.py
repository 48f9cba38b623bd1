"""Lens surface and baffle triangle meshes
(mitsuba_tpu/lens/geometry.py; reference lens_design/geometry.py of the
fork), host-side numpy.

An open disk whose (x, y) template is fixed and whose z comes from the
surface's sag, so that an optimizer step only recomputes z; and an
annular baffle that blocks rays outside the element's radius.  The disk
is polar (rings x sectors), with a watertight rim, as in the JAX package.
"""
from __future__ import annotations

import numpy as np


def polar_disk(n_rings: int, n_sectors: int, radius: float):
    """(V (Nv,2), F (Nf,3)) open disk in the plane, center vertex first."""
    vs = [(0.0, 0.0)]
    for i in range(1, n_rings + 1):
        r = radius * i / n_rings
        for j in range(n_sectors):
            a = 2.0 * np.pi * j / n_sectors
            vs.append((r * np.cos(a), r * np.sin(a)))
    V = np.asarray(vs, np.float32)

    F = []
    # center fan
    for j in range(n_sectors):
        F.append([0, 1 + j, 1 + (j + 1) % n_sectors])
    # ring quads
    for i in range(1, n_rings):
        base0 = 1 + (i - 1) * n_sectors
        base1 = 1 + i * n_sectors
        for j in range(n_sectors):
            j1 = (j + 1) % n_sectors
            F.append([base0 + j, base1 + j, base1 + j1])
            F.append([base0 + j, base1 + j1, base0 + j1])
    return V, np.asarray(F, np.int32)


def create_surface_geometry(n_rings: int, n_sectors: int, r_element: float,
                            sag_np, baffle_radius: float | None = None,
                            flip_normals: bool = False):
    """One lens surface + its baffle (geometry.py:296 [FORK]).

    sag_np: (x, y) -> z numpy-compatible callable.
    Returns (V_lens (Nv,3), F_lens, V_baffle, F_baffle).  The lens mesh's
    (x, y) are the FIXED template; re-mesh after a parameter step by
    re-evaluating the sag at the same (x, y) (lens.py:509 update()).
    """
    if baffle_radius is None:
        baffle_radius = 1.1 * r_element
    V2, F = polar_disk(n_rings, n_sectors, r_element)
    z = np.asarray(sag_np(V2[:, 0], V2[:, 1]), np.float32)
    V = np.concatenate([V2, z[:, None]], axis=-1)
    if flip_normals:
        F = F[:, ::-1].copy()

    # baffle: annulus from the element rim to baffle_radius at the rim z
    rim_z = float(np.asarray(sag_np(np.asarray([r_element]),
                                    np.asarray([0.0])))[0])
    n_s = n_sectors
    inner = np.stack(
        [r_element * np.cos(2 * np.pi * np.arange(n_s) / n_s),
         r_element * np.sin(2 * np.pi * np.arange(n_s) / n_s),
         np.full(n_s, rim_z)], axis=-1).astype(np.float32)
    outer = inner.copy()
    outer[:, :2] *= baffle_radius / r_element
    V_b = np.concatenate([inner, outer])
    F_b = []
    for j in range(n_s):
        j1 = (j + 1) % n_s
        F_b.append([j, n_s + j, n_s + j1])
        F_b.append([j, n_s + j1, j1])
    F_b = np.asarray(F_b, np.int32)
    if flip_normals:
        F_b = F_b[:, ::-1].copy()
    return V, F, V_b, F_b
