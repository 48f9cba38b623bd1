"""Lens prescriptions and the generic table builder
(mitsuba_tpu/lens/designs.py; reference src/sensors/realisticlens.cpp:
936-1567): the 15 named ``lens_design`` strings, whose tables
(curvatures, thicknesses, radii, glasses) are numeric data from public
sources (photonstophotos' optical bench, Smith's Modern Optical
Engineering, patent US11561375B2, henryquach.org/tessar).

The table conventions of build_lens_from_data (realisticlens.cpp:
1568-1652):

- the tables run from the world side to the film side; the interfaces
  are built film side first, thicknesses accumulated from the film (z
  grows toward the world), so ``interfaces[0]`` is the rear element;
- spherical curvatures change sign against the table's convention;
- lengths are millimetres, scaled by 0.001 * scale into metres;
- the glass list has N + 1 entries; interface i has left = mats[i + 1]
  (the world side) and right = mats[i] (the film side);
- aspheres keep the table's curvature and coefficients, made unitless
  against the element radius (c_ = R_elem / R_curv, ai_ = ai *
  R_elem^(2i+3)).

Every builder takes the ``device`` its tensors go to, and gives each
interface glass tensors of its own (``DispersiveMaterial.copy_to``), so
that each path of ``utils/params.traverse`` is its own leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from .elements import ApertureStop, AsphericalLens, PlanoLens, SpheroidLens
from .materials import AIR, DispersiveMaterial

_cauchy = DispersiveMaterial.cauchy_material
_sellmeier = DispersiveMaterial.sellmeier_material


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def build_lens_from_data(interface_types, thicknesses, curv_radii,
                         elem_radii, kappas, ai_list, mats,
                         scale: float = 1.0, stopdown_ratio: float = 1.0,
                         device=None):
    """The interfaces, rear first, of a prescription table
    (realisticlens.cpp:1568)."""
    n = len(thicknesses)
    interfaces = []
    z_pos = 0.0
    for i in range(n - 1, -1, -1):
        z_pos += thicknesses[i]
        er = 0.001 * scale * elem_radii[i]
        kw = dict(z_intercept=_f32(0.001 * scale * z_pos, device),
                  left=mats[i + 1].copy_to(device),
                  right=mats[i].copy_to(device))
        kind = interface_types[i]
        if kind == "aperture":
            interfaces.append(ApertureStop(
                element_radius=_f32(er * stopdown_ratio, device), **kw))
        elif kind == "plane":
            interfaces.append(PlanoLens(element_radius=_f32(er, device),
                                        **kw))
        elif kind == "asphere":
            ai = np.asarray(ai_list[i], np.float32)
            r_tab = float(elem_radii[i])
            ai_unitless = np.array(
                [a * r_tab ** (2 * j + 3) for j, a in enumerate(ai)],
                np.float32)
            interfaces.append(AsphericalLens(
                c_unitless=_f32(r_tab / float(curv_radii[i]), device),
                kappa=_f32(float(kappas[i]), device),
                ai=torch.as_tensor(ai_unitless).to(device),
                element_radius=_f32(er, device), **kw))
        else:
            interfaces.append(SpheroidLens(
                curvature_radius=_f32(-0.001 * scale * float(curv_radii[i]),
                                      device),
                element_radius=_f32(er, device), **kw))
    return tuple(interfaces)


def _sphere(curvature_radius, element_radius, z, left, right, device):
    return SpheroidLens(curvature_radius=_f32(curvature_radius, device),
                        element_radius=_f32(element_radius, device),
                        z_intercept=_f32(z, device),
                        left=left.copy_to(device), right=right.copy_to(device))


def build_singlet(object_distance=6.0, curvature_radius=0.05,
                  lens_radius=0.005, device=None):
    """A biconvex singlet placed by the thin-lens equation
    (realisticlens.cpp:936-960)."""
    distance = max(object_distance, 4.001 * curvature_radius)
    z = 0.5 * distance * (1.0 - np.sqrt(1.0 - 4.0 * curvature_radius
                                        / distance))
    thickness = 2.0 * curvature_radius * (
        1.0 - np.sqrt(1.0 - (lens_radius / curvature_radius) ** 2))
    glass = _cauchy("NBK7", 1.5046, 5 * 0.00420)
    return (_sphere(curvature_radius, lens_radius, z, AIR, glass, device),
            _sphere(-curvature_radius, lens_radius, z + thickness, glass,
                    AIR, device))


def build_doublet(object_distance=6.0, R=0.025, lens_radius=0.005,
                  device=None):
    """A plane, a cemented doublet and a stop (realisticlens.cpp:963-985)."""
    focal_length = 2.0 * R
    distance = max(object_distance, 4.001 * focal_length)
    z = 0.5 * distance * (1.0 - np.sqrt(1.0 - 4.0 * focal_length / distance))
    th = 2.0 * R * (1.0 - np.sqrt(1.0 - (lens_radius / R) ** 2))
    g1 = _cauchy("NBK7", 1.5046, 0.00420)
    g2 = _cauchy("mod-NBK7", 1.5046, 0.00860948454)
    return (
        PlanoLens(element_radius=_f32(lens_radius, device),
                  z_intercept=_f32(z, device), left=AIR.copy_to(device),
                  right=g2.copy_to(device)),
        _sphere(R, lens_radius, z + th, g2, g1, device),
        _sphere(-R, lens_radius, z + 2 * th, g1, AIR, device),
        ApertureStop(element_radius=_f32(lens_radius, device),
                     z_intercept=_f32(z + 3 * th, device),
                     left=AIR.copy_to(device), right=AIR.copy_to(device)),
    )


def _spheres_and_stop(types, curv, thick, radii, mats, device):
    """A table of spheres and one stop (no conics, no asphere terms)."""
    n = len(thick)
    return build_lens_from_data(types, thick, curv, radii, [0.0] * n,
                                [[0.0] * 7] * n, mats, device=device)


def build_tessar(device=None):
    """Tessar (henryquach.org/tessar; realisticlens.cpp:988)."""
    NLAK9 = _sellmeier("NLAK9", [1.462319050, 0.344399589, 1.155083720],
                       [0.007242702, 0.0243353131, 85.46868680])
    K10 = _sellmeier("K10", [1.156870820, 0.064262544, 0.872376139],
                     [0.008094243, 0.0386051284, 104.74773000])
    F2 = _sellmeier("F2", [1.397570370, 0.159201403, 1.268654300],
                    [0.009959061, 0.0546931752, 119.24834600])
    types = ["sphere"] * 4 + ["aperture"] + ["sphere"] * 3
    curv = [35.034, -296.111, -63.028, 31.297, 1e8, -86.620, 45.344, -43.567]
    thick = [3.567, 2.286, 2.290, 2.289, 1.999, 2.286, 9.941, 86.917]
    radii = [9.0, 9.0, 6.0, 6.0, 4.65, 8.0, 8.0, 8.0]
    mats = [AIR, NLAK9, AIR, F2, AIR, AIR, K10, NLAK9, AIR]
    return _spheres_and_stop(types, curv, thick, radii, mats, device)


def build_helios(device=None):
    """Helios 44M-4 (photonstophotos GOI/ST01FB06; realisticlens.cpp:1031)."""
    BF16 = _cauchy("BF16", 1.648275034, 0.007806736)
    TK14 = _cauchy("TK14", 1.597547619, 0.005351918)
    LF7 = _cauchy("LF7", 1.551328271, 0.008025103)
    types = ["sphere"] * 5 + ["aperture"] + ["sphere"] * 5
    curv = [38.07, 136.365, 25.33, -124.225, 15.995, 1e8, -16.62, 66.085,
            -22.21, 191.54, -52.725]
    thick = [4.81, 2.26, 9.07, 1.31, 4.7, 4.63, 1.32, 6.25, 0.5, 4.94, 38.08]
    radii = [14.75, 14.75, 13.2, 11.6, 9.75, 9.575, 9.35, 10.2, 10.6, 12.35,
             12.35]
    mats = [AIR, TK14, AIR, TK14, LF7, AIR, AIR, LF7, TK14, AIR, BF16, AIR]
    return _spheres_and_stop(types, curv, thick, radii, mats, device)


def build_jupiter(device=None):
    """Jupiter-9 (photonstophotos GOI/ST01FB43; realisticlens.cpp:1090)."""
    TK16 = _cauchy("TK16", 1.596466676, 0.00558386)
    BF13 = _cauchy("BF13", 1.618336084, 0.007302944)
    K1 = _cauchy("K1", 1.486688667, 0.00398663)
    TF2 = _cauchy("TF2", 1.637217608, 0.012112489)
    OF1 = _cauchy("OF1", 1.513488027, 0.005500433)
    BF7 = _cauchy("BF7", 1.562693323, 0.005811246)
    types = ["sphere"] * 6 + ["aperture"] + ["sphere"] * 4
    curv = [46.45, 268.5, 25.94, 52.0, -264.2, 16.444, 1e8, -1043.65, 44.51,
            -15.031, -95.06]
    thick = [5.6, 0.4, 5.8, 7.5, 1.8, 10.0, 3.8, 2.8, 10.6, 2.9, 40.53]
    radii = [22.0, 22.0, 19.015, 19.015, 19.015, 12.68, 12.275, 12.285,
             13.5, 13.5, 15.15]
    mats = [AIR, TK16, AIR, BF13, K1, TF2, AIR, AIR, OF1, BF13, BF7, AIR]
    return _spheres_and_stop(types, curv, thick, radii, mats, device)


def build_fisheye(device=None):
    """Canon EF15mm f/2.8 (JP1988-017421 ex. 3; realisticlens.cpp:1152)."""
    gA = _cauchy("glass_A", 1.5881276381075704, 0.005202992085188941)
    gB = _cauchy("glass_B", 1.793242496642434, 0.018550536235572006)
    gC = _cauchy("glass_C", 1.4770186893501427, 0.003636419065560783)
    gD = _cauchy("glass_D", 1.6021851259042148, 0.005144827846028017)
    gE = _cauchy("glass_E", 1.4983808648479255, 0.004423976662977713)
    types = ["sphere"] * 8 + ["aperture"] + ["sphere"] * 7
    curv = [78.06, 15.9, 22.22, 13.27, 127.88, 22.35, 32.04, -190.22, -1e6,
            -289.77, -29.1, -100.42, 29.39, -25.73, 43.88, -43.88]
    thick = [2.5, 11.83, 2.5, 7.54, 5.34, 1.85, 6.71, 3.84, 3.53, 2.72,
             0.15, 3.99, 5.14, 0.15, 4.84, 39.67]
    radii = [31.725, 15.9, 13.89, 10.69, 9.955, 7.61, 6.73, 6.73, 6.659,
             7.21, 7.21, 9.52, 9.52, 9.52, 11.71, 11.71]
    mats = [AIR, gA, AIR, gD, AIR, gA, AIR, gB, AIR, AIR, gE, AIR, gB, gC,
            AIR, gC, AIR]
    return _spheres_and_stop(types, curv, thick, radii, mats, device)


def build_gauss(device=None):
    """Double Gauss (Smith, Modern Optical Engineering;
    realisticlens.cpp:1224)."""
    gA = _cauchy("glass_A", 1.64855004723031, 0.00744902140861971)
    gB = _cauchy("glass_B", 1.66398266226799, 0.0121606281020403)
    gC = _cauchy("glass_C", 1.57907201321296, 0.00830957940819446)
    gD = _cauchy("glass_D", 1.64068415393588, 0.00601335161083744)
    gE = _cauchy("glass_E", 1.69447574875623, 0.00782209786331075)
    types = ["sphere"] * 5 + ["aperture"] + ["sphere"] * 5
    curv = [58.95, 169.66, 38.55, 81.54, 25.5, 1e7, -28.99, 81.54, -40.77,
            874.13, -79.46]
    thick = [7.52, 0.24, 8.05, 6.55, 11.41, 9.0, 2.36, 12.13, 0.38, 6.44,
             72.228]
    radii = [25.2, 25.2, 23.0, 23.0, 18.0, 17.1, 17.0, 20.0, 20.0, 20.0,
             20.0]
    mats = [AIR, gA, AIR, gA, gB, AIR, AIR, gC, gD, AIR, gE, AIR]
    return _spheres_and_stop(types, curv, thick, radii, mats, device)


def build_exp1_doublet(mat_cauchy_A, mat_cauchy_B, device=None):
    """The doublet of the glass and geometry recovery experiment
    (realisticlens.cpp:1283)."""
    gA = _cauchy("glass_A", 1.4560798389592584, 0.021086562958141358)
    gB = _cauchy("glass_B", mat_cauchy_A, mat_cauchy_B)
    types = ["aperture", "sphere", "sphere", "sphere"]
    curv = [1000.0, 24.0, -24.0, -168.01068267]
    thick = [0.0, 3.0, 2.25291824, 46.74708176]
    radii = [8.0, 8.0, 8.0, 8.0]
    mats = [AIR, AIR, gA, gB, AIR]
    return _spheres_and_stop(types, curv, thick, radii, mats, device)


def build_hypercentric(ap_radius=1.0, focal_lengths=2.0, device=None):
    """Hypercentric (telecentric) lens (realisticlens.cpp:1322).  Returns
    (interfaces, film_z_position)."""
    SF6 = _cauchy("SF6", 1.757435971209294, 0.016580283248837778)
    target_img_size = 5.0
    lens_radius = 120.0
    track_length = 450.0
    curvature_radius = 310.505660861
    lens_thickness = 50.0
    z_ap_to_lens = 210.0 * focal_lengths
    z_film_to_ap = z_ap_to_lens * (target_img_size - ap_radius) / (
        lens_radius + ap_radius)
    curv = [curvature_radius, -curvature_radius, np.inf]
    thick = [lens_thickness, z_ap_to_lens - lens_thickness * 0.5,
             z_film_to_ap]
    radii = [lens_radius, lens_radius, ap_radius]
    mats = [AIR, SF6, AIR, AIR]
    interfaces = []
    z_pos = 0.0
    for i in range(2, -1, -1):
        z_pos += thick[i]
        if i == 2:
            interfaces.append(ApertureStop(
                element_radius=_f32(0.001 * radii[i], device),
                z_intercept=_f32(0.001 * z_pos, device),
                left=AIR.copy_to(device), right=AIR.copy_to(device)))
        else:
            interfaces.append(_sphere(-0.001 * curv[i], 0.001 * radii[i],
                                      0.001 * z_pos, mats[i + 1], mats[i],
                                      device))
    return tuple(interfaces), 0.001 * (track_length - sum(thick))


def build_asph(device=None):
    """A smartphone-style all-aspheric lens (patent US11561375B2 emb. 1;
    realisticlens.cpp:1373)."""
    gA = _cauchy("glass_A", 1.52923858553436, 0.00509603519451627)
    gB = _cauchy("glass_B", 1.59833561885235, 0.0143836590443554)
    gC = _cauchy("glass_C", 1.5205859418518, 0.00497611850070528)
    nbk7 = _cauchy("NBK7", 1.50478491769513, 0.00421697320906858)
    types = ["asphere", "aperture"] + ["asphere"] * 11 + ["plane", "plane"]
    curv = [1.952, 1e8, 2.978, 2.003, 2.167, 4.143, -3.947, -0.969, -2.089,
            3.867, -0.847, -16.711, 0.785, 1e8, 1e8]
    thick = [0.118, 0.28, 0.069, 0.28, 0.205, 0.551, 0.211, 0.421, 0.03,
             1.105, 0.03, 0.44, 0.7, 0.3, 0.235]
    radii = [0.72391, 0.70781, 0.79221, 0.79661, 0.91103, 0.94416, 1.05504,
             1.07363, 1.26654, 1.33913, 1.56417, 1.81331, 2.37438, 2.72353,
             2.72353]
    kappas = [-2.1201, 0.0, -20.0, -12.382, -3.006, 1.0, 0.0, -1.4213,
              -3.0569, -6.3368, -4.2091, -20.0, -5.1631, 0.0, 0.0]
    ai = [
        [3.5988e-03, 3.7387e-01, -1.3929e+00, 1.4094e+00, 2.0282e+00,
         -3.6199e+00, 0.0],
        [0.0] * 7,
        [-1.7492e-01, 9.8443e-02, 6.6244e-01, -1.7257e+00, 6.6955e-01,
         -3.4243e-01, 0.0],
        [-2.6551e-01, 5.7642e-01, -1.1253e+00, 1.1555e+00, 1.4439e-02,
         -1.9141e+00, 0.0],
        [-2.5306e-01, 3.1573e-01, -2.1258e-01, 9.4103e-02, -2.7001e-01,
         1.1110e-01, 0.0],
        [-1.4680e-01, -1.9199e-02, 1.1489e-01, -1.6910e-01, -1.1287e-01,
         1.2615e-01, 0.0],
        [-4.4328e-02, -1.6599e-01, 4.8223e-02, 9.4653e-03, 1.2137e-02,
         -8.1558e-03, 0.0],
        [3.3847e-01, -8.7891e-01, 1.1445e+00, -9.1578e-01, 5.9482e-01,
         -2.0143e-01, 0.0],
        [1.4102e-01, -2.7755e-01, 3.2138e-01, -2.4968e-01, 1.2901e-01,
         -2.7976e-02, 0.0],
        [-1.6984e-01, 1.4944e-01, -9.9124e-02, 1.3353e-02, 1.6198e-03,
         1.2524e-03, 0.0],
        [-6.7672e-02, -3.0645e-02, 1.0444e-01, -8.3869e-02, 2.6536e-02,
         -2.7869e-03, 0.0],
        [-1.3442e-01, 3.8933e-02, -6.2383e-03, 7.5356e-04, 2.2005e-04,
         -5.2957e-05, 0.0],
        [-7.5325e-02, 2.4095e-02, -5.8920e-03, 1.0269e-03, -1.1564e-04,
         5.9417e-06, 0.0],
        [0.0] * 7,
        [0.0] * 7,
    ]
    mats = [AIR, gA, gA, AIR, gB, AIR, gA, AIR, gB, AIR, gC, AIR, gC, AIR,
            nbk7, AIR]
    return build_lens_from_data(types, thick, curv, radii, kappas, ai, mats,
                                device=device)


def build_exp2_nikon(mode: int = 0, device=None):
    """A Nikon 28 mm-style prescription in three asphere variants
    (realisticlens.cpp:1452)."""
    g = {
        "A": _cauchy("glass_A", 1.5046464980225065, 0.004220601200948007),
        "B": _cauchy("glass_B", 1.8645930283464647, 0.013233579146425922),
        "C": _cauchy("glass_C", 1.5725988459469284, 0.007952986594191858),
        "D": _cauchy("glass_D", 1.6639243971469755, 0.012180862092226684),
        "E": _cauchy("glass_E", 1.8718384392978837, 0.013530356122431513),
        "F": _cauchy("glass_F", 1.5797734345478602, 0.0045237938738434446),
        "G": _cauchy("glass_G", 1.689190440676433, 0.010873011246216379),
        "H": _cauchy("glass_H", 1.5673889795706786, 0.008789871710972213),
        "I": _cauchy("glass_I", 1.6738434507974307, 0.006826218099482183),
        "J": _cauchy("glass_J", 1.4770641526601842, 0.00362410356265244),
    }
    types = (["sphere"] * 11 + ["aperture"] + ["sphere"] * 4
             + ["asphere"] * 2 + ["sphere"] * 2 + ["plane"] * 2)
    curv = [5.2674, 0.9607, 1.442, 10.2799, 1.2154, -1.0987, 2.9183,
            -1.6693, 1.6429, -1.4116, -2.5725, 1e8, -0.973, -24.0801,
            2.3756, -1.3055, -7.3169, -2.2, -1.5449, -7.2572, 1e8, 1e8]
    thick = [0.102, 0.309, 0.246, 0.083, 0.411, 0.088, 0.258, 0.009, 0.379,
             0.069, 0.118, 0.604, 0.051, 0.009, 0.282, 0.239, 0.122, 0.154,
             0.083, 0.75, 0.074, 0.0425]
    radii = [0.847, 0.696, 0.661, 0.625, 0.546, 0.524, 0.586, 0.601, 0.624,
             0.613, 0.607, 0.555, 0.476, 0.49, 0.543, 0.569, 0.604, 0.627,
             0.662, 0.712, 1.2, 1.2]
    ai = [[0.0] * 7 for _ in range(22)]
    if mode == 0:
        ai[16] = [-0.24, -0.4268, 0.0, 0.0, 0.0, 0.0, 0.0]
        ai[17] = [-0.05053, -0.3491, 0.1459, 0.07718, 0.0, 0.0, 0.0]
    elif mode == 2:
        ai[16] = [-0.09490284323692322, -0.10803833603858948,
                  -0.08069773763418198, -0.01646527275443077,
                  -0.007415791507810354, -0.503877580165863,
                  -3.2629644870758057]
        ai[17] = [0.07706142961978912, 0.06080370396375656,
                  -0.015299857594072819, -0.16691075265407562,
                  -0.38500601053237915, -0.5226516723632812,
                  0.1124117523431778]
    mats = [AIR, g["A"], AIR, g["B"], g["C"], AIR, g["D"], g["E"], AIR,
            g["F"], g["G"], AIR, AIR, g["H"], AIR, g["F"], AIR, g["I"],
            AIR, g["J"], AIR, g["A"], AIR]
    return build_lens_from_data(types, thick, curv, radii, [0.0] * 22, ai,
                                mats, scale=35.0 / 1.57, stopdown_ratio=0.5,
                                device=device)


# the experiments' second glasses, Cauchy (A, B)
_EXP1_GLASS = {"exp1a": (1.5689525390422485, 0.0263051608728981),
               "exp1b": (1.507009332993809, 0.04781645616233479),
               "exp1c": (1.5030211256389316, 0.04920145883751409)}
_FIXED_DESIGNS = {"tessar": build_tessar, "helios": build_helios,
                  "jupiter": build_jupiter, "fisheye": build_fisheye,
                  "gauss": build_gauss}
DESIGNS = ("singlet", "doublet", "tessar", "helios", "jupiter", "fisheye",
           "gauss", "hypercentric", "asph", "exp1a", "exp1b", "exp1c",
           "exp2a", "exp2b", "exp2c")


def build_design(name: str, device=None, **kw):
    """(interfaces, film_z_position, enable_fine_focus) of a named design
    (the constructor's dispatch, realisticlens.cpp:843-897); an unknown
    name builds the singlet."""
    if name in _FIXED_DESIGNS:
        return _FIXED_DESIGNS[name](device), 0.0, True
    if name == "hypercentric":
        ifaces, film_z = build_hypercentric(kw.get("ap_size", 1.0),
                                            kw.get("ap_offset", 2.0), device)
        return ifaces, film_z, False
    if name == "asph":
        return build_asph(device), 0.0, False
    if name in _EXP1_GLASS:
        return build_exp1_doublet(*_EXP1_GLASS[name], device), 0.0, True
    if name in ("exp2a", "exp2b", "exp2c"):
        return build_exp2_nikon("abc".index(name[-1]), device), 0.0, True
    args = (kw.get("object_distance", 6.0), kw.get("lens_focal_length", 0.05))
    if name == "doublet":
        return build_doublet(args[0], args[1] / 2,
                             kw.get("lens_diameter", 0.01) / 2, device), \
            0.0, True
    return build_singlet(*args, kw.get("lens_diameter", 0.01) / 2,
                         device), 0.0, True
