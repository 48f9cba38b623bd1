"""The port's scene loading against mitsuba_tpu on the CPU: the XML
parser's dicts, the loaded scenes' geometry and plugins, per-lane renders
of the loaded Cornell box and of its variant with a point and a spot
light, ``render(scene)`` with the scene's own integrator, the types the
port raises for, and the command line.

Both loaders read the same dicts (the JAX package's ``cornell_box_dict``
and the port's ``delta_lights_dict`` additions).  The per-lane bar is
PERF.md section 2's: at least 99.5 % of lanes within rtol = atol = 2e-3
and the mean within 2e-3."""
import numpy as np
import pytest
import torch

from mitsuba_tpu.models.film import ReconstructionFilter as JFilter
from mitsuba_tpu.models.film import splat_grouped as jsplat_grouped
from mitsuba_tpu.utils import xml as jxml
from mitsuba_tpu.utils.load import load_dict as jload_dict
from mitsuba_tpu.utils.scenes import cornell_box_dict as jcornell_box_dict
from mitsuba_tpu_torch import (DepthIntegrator, ParticleTracerIntegrator,
                               PathIntegrator, load_dict, load_file, render,
                               sample_rays)
from mitsuba_tpu_torch.__main__ import main
from mitsuba_tpu_torch.models.film import ReconstructionFilter, splat_grouped
from mitsuba_tpu_torch.utils import xml
from mitsuba_tpu_torch.utils.bitmap import read_image
from mitsuba_tpu_torch.utils.scenes import cornell_box_dict, delta_lights_dict
from test_xml import _XML
from torch_parity import jax_path_lanes

SEED, SIZE, SPP, DEPTH = 3, 16, 2, 3

_XML_V1 = """
<scene version="0.6.0">
  <default name="res" value="16"/>
  <default name="resx" value="24"/>
  <sensor type="perspective">
    <float name="nearClip" value="0.01"/>
    <float name="fov" value="40"/>
    <transform name="toWorld">
      <lookAt origin="0,0,-3" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$resx"/>
      <integer name="height" value="$res"/>
      <rfilter type="mitchell"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="_mat">
    <rgb name="diffuseReflectance" value="0.4 0.5 0.6"/>
    <float name="uoffset" value="0.25"/>
  </bsdf>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="0.5"/>
      <rotate y="1" angle="30"/>
      <matrix value="1 0 0 0.1  0 1 0 0.2  0 0 1 0.3  0 0 0 1"/>
      <translate value="0.1"/>
    </transform>
    <ref id="_mat"/>
    <emitter type="area"><spectrum name="radiance" value="2.5"/></emitter>
  </shape>
  <emitter type="spot">
    <point name="position" x="0" y="1" z="0"/>
    <vector name="direction" value="0, -1, 0"/>
    <float name="cutoffAngle" value="25"/>
  </emitter>
</scene>
"""


def _same_dict(got, want, path=""):
    """Equal, the transforms within 1e-6 (the two packages compose them by
    different float32 matrix products)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_dict(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray) or hasattr(want, "shape"):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-6, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("text", [_XML, _XML_V1], ids=["v3", "v0.6"])
def test_xml_to_dict_matches_jax(text):
    """The dicts of tests/test_xml.py's scene and of a pre-2.0 scene with
    camelCase names, $res against $resx, <lookAt>, <matrix>, <ref>,
    a uv-offset float, and a caller's default over the file's."""
    for defaults in (None, {"res": "20", "spp": "3"}):
        _same_dict(xml.xml_to_dict(text, defaults),
                   jxml.xml_to_dict(text, defaults))
    d = xml.xml_to_dict(_XML_V1)
    assert d["sensor"]["film"]["width"] == 24
    assert d["sensor"]["film"]["height"] == 16
    assert "reflectance" in d["ID_mat__UPGR"]
    assert d["emitter"]["cutoff_angle"] == 25.0


def test_cornell_box_dict_matches_jax():
    _same_dict(cornell_box_dict(12, 10, 3), jcornell_box_dict(12, 10, 3))


def _lanes_close(got, want):
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3).all(axis=-1)
    mean_err = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-12)
    assert close.mean() >= 0.995 and mean_err <= 2e-3, (close.mean(),
                                                        mean_err)


@pytest.mark.parametrize("variant", ["cornell", "point_spot"])
def test_loaded_lanes_match_jax(variant):
    """Each lane's radiance from the port's ``load_dict`` of a scene dict
    against the JAX package's ``load_dict`` of the same dict, 16 x 16 x 2
    spp, depth 3: the Cornell box, and with a point and a spot light
    (NEE to them with MIS weight 1)."""
    d = jcornell_box_dict(SIZE, SIZE, SPP)
    if variant != "cornell":
        extra = delta_lights_dict(SIZE, SIZE, SPP, variant)
        d.update({k: v for k, v in extra.items() if k not in d})
    want = jax_path_lanes(jload_dict(d), SEED, SPP, DEPTH)
    scene = load_dict(d, device="cpu")
    ray, _, _, lane = sample_rays(scene, SEED, SPP)
    got = PathIntegrator(DEPTH, 5).sample(
        scene, ray, lane, SEED, torch.ones(lane.shape, dtype=torch.bool))
    _lanes_close(got.numpy(), want)


def test_loaded_scene_plugins():
    """Shapes, BSDFs, lights and the sensor a dict names, against the JAX
    loader's: mesh vertices and faces, an analytic sphere, a merge, a
    shape group's instances, the emitters' parameters, the film."""
    cube = np.eye(4, dtype=np.float32) * 0.2
    cube[3, 3] = 1.0
    d = {"type": "scene",
         "sensor": {"type": "perspective", "fov": 45.0,
                    "film": {"type": "hdrfilm", "width": 8, "height": 6,
                             "rfilter": {"type": "lanczos"}}},
         "metal": {"type": "roughconductor", "material": "Cu",
                   "alpha": 0.2},
         "ball": {"type": "sphere", "center": [0.1, 0.2, 0.3],
                  "radius": 0.4, "subdiv": 2, "bsdf": {"type": "ref",
                                                       "id": "metal"}},
         "exact": {"type": "sphere", "analytic": True, "center": [0, 1, 0],
                   "radius": 0.3, "emitter": {"type": "area"}},
         "can": {"type": "cylinder", "radius": 0.2, "p1": [0, 0.5, 0],
                 "capped": True,
                 "bsdf": {"type": "plastic", "int_ior": "bk7"}},
         "pair": {"type": "merge",
                  "a": {"type": "rectangle", "bsdf": {"type": "ref",
                                                      "id": "metal"}},
                  "b": {"type": "disk", "bsdf": {"type": "ref",
                                                 "id": "metal"}}},
         "group": {"type": "shapegroup", "box": {"type": "cube",
                                                 "to_world": cube}},
         "inst": {"type": "instance", "shapegroup": {"type": "ref",
                                                     "id": "group"},
                  "to_world": np.diag([1.0, 2.0, 1.0, 1.0]).astype(
                      np.float32)},
         "sky": {"type": "constant", "radiance": 0.5,
                 "sampling_weight": 2.0},
         "proj": {"type": "projector", "irradiance": {"type": "rgb",
                                                      "value": [1, 2, 3]},
                  "position": [0, 0, 2], "direction": [0, 0, -1]},
         "integrator": {"type": "depth"}}
    js, ps = jload_dict(d), load_dict(d, device="cpu")
    assert len(ps.meshes) == len(js.meshes)
    for pm, jm in zip(ps.meshes, js.meshes):
        np.testing.assert_allclose(pm.vertices.numpy(), np.asarray(jm.vertices),
                                   rtol=1e-6, atol=1e-6)
        assert np.array_equal(pm.faces.numpy(), np.asarray(jm.faces))
        assert (pm.bsdf_index, pm.emitter_index) == (jm.bsdf_index,
                                                     jm.emitter_index)
    np.testing.assert_allclose(ps.scene_analytic.sp_center.numpy(),
                               np.asarray(js.scene_analytic.sp_center))
    assert ps.shape_emitter == js.shape_emitter
    assert ps.env_index == js.env_index == 1
    assert [type(e).__name__ for e in ps.emitters] == \
        [type(e).__name__ for e in js.emitters]
    np.testing.assert_allclose(ps.emitter_distr.pmf.numpy(),
                               np.asarray(js.emitter_distr.pmf))
    np.testing.assert_allclose(ps.emitters[1].scene_radius,
                               float(js.emitters[1].scene_radius), rtol=1e-6)
    assert len(ps.instances) == 1 and ps.instances[0].n_submeshes == 1
    assert ps.sensor.film.rfilter.kind == "lanczos"
    assert isinstance(ps.integrator, DepthIntegrator)
    np.testing.assert_allclose(ps.bsdfs[0].k.numpy(),
                               np.asarray(js.bsdfs[0].k))
    depth = render(ps, seed=0, spp=1, device="cpu")
    assert depth.shape == (6, 8, 3) and float(depth.max()) > 0


def test_envmap_file_sdf_and_collimated_source(tmp_path):
    """An envmap read from an EXR file, an SDF grid and a collimated area
    source load as the JAX loader loads them (its envmap from the same
    texels as data: the JAX package reads no EXR without OpenEXR)."""
    from mitsuba_tpu_torch.utils.bitmap import write_image

    texels = np.random.default_rng(8).uniform(0.1, 2.0, (8, 16, 3)).astype(
        np.float32)
    write_image(str(tmp_path / "sky.exr"), texels)
    grid = np.random.default_rng(9).uniform(-1, 1, (4, 5, 6)).astype(
        np.float32)
    d = {"type": "scene",
         "sky": {"type": "envmap", "filename": str(tmp_path / "sky.exr"),
                 "scale": 0.5},
         "blob": {"type": "sdfgrid", "data": grid, "bbox_min": [-1, 0, 0],
                  "bsdf": {"type": "diffuse"}},
         "panel": {"type": "rectangle", "emitter": {
             "type": "directionalarea", "sampling_weight": 2.0}}}
    ps = load_dict(d, device="cpu")
    js = jload_dict(dict(d, sky=dict(d["sky"], data=texels)))
    assert np.array_equal(ps.emitters[0].data.numpy(),
                          np.asarray(js.emitters[0].data))
    assert ps.env_index == js.env_index == 0
    assert float(ps.emitters[0].scale) == float(js.emitters[0].scale)
    assert np.array_equal(ps.scene_sdf.values.numpy(),
                          np.asarray(js.scene_sdf.values))
    assert ps.shape_bsdf == js.shape_bsdf
    assert type(ps.emitters[1]).__name__ == "DirectionalAreaEmitter"
    assert ps.emitters[1].sampling_weight == js.emitters[1].sampling_weight


def test_two_infinite_emitters_keep_the_last():
    """Two infinite emitters in one dict: the last is the scene's
    environment, as in the JAX package's make_scene; both take the
    scene's bounding sphere."""
    d = cornell_box_dict(4, 4, 1)
    d["sky"] = {"type": "constant", "radiance": 0.2}
    d["sun"] = {"type": "directional", "direction": [0, -1, -1]}
    js, ps = jload_dict(d), load_dict(d, device="cpu")
    assert ps.env_index == js.env_index == 2
    for pe, je in zip(ps.emitters[1:], js.emitters[1:]):
        np.testing.assert_allclose(pe.scene_radius, float(je.scene_radius),
                                   rtol=1e-6)
        np.testing.assert_allclose(pe.scene_center,
                                   np.asarray(je.scene_center), atol=1e-6)


@pytest.mark.parametrize("kind", ["mitchell", "catmullrom", "lanczos"])
def test_filters_match_jax(kind):
    """The three filters' values and the scatter-free splat under each
    (its 2 ceil(radius) + 1 taps an axis) against the JAX package's."""
    r = np.random.default_rng(4)
    x = r.uniform(-4.0, 4.0, 4096).astype(np.float32)
    pf, jf = getattr(ReconstructionFilter, kind)(), getattr(JFilter, kind)()
    np.testing.assert_allclose(pf.eval_1d(torch.tensor(x)).numpy(),
                               np.asarray(jf.eval_1d(x)), rtol=0, atol=2e-7)
    h, w, spp = 6, 5, 3
    px = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2)
    pos = (np.repeat(px, spp, 0) + r.uniform(size=(h * w * spp, 2))).astype(
        np.float32)
    val = r.uniform(size=(h * w * spp, 3)).astype(np.float32)
    np.testing.assert_allclose(
        splat_grouped(torch.tensor(pos), torch.tensor(val), h, w, spp,
                      pf).numpy(),
        np.asarray(jsplat_grouped(pos, val, h, w, spp, jf)), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("d", [
    {"type": "d65", "scale": 2.0}, {"type": "blackbody",
                                    "temperature": 3200.0},
    {"type": "regular", "values": [0.1, 0.7, 0.3, 0.9, 0.2],
     "lambda_min": 400.0, "lambda_max": 700.0},
    {"type": "irregular", "wavelengths": [390.0, 450.0, 520.0, 710.0],
     "values": [0.1, 0.5, 0.9, 0.2]}], ids=lambda d: d["type"])
def test_spectrum_rgb_matches_jax(d):
    """The loader's spectra (models/spectra.py ``to_rgb``) within 1e-6 of
    the JAX loader's ``_spectrum``, relative to the largest channel."""
    from mitsuba_tpu.utils.load import _spectrum
    from mitsuba_tpu_torch.models.spectra import spectrum_rgb

    got, want = spectrum_rgb(d), np.asarray(_spectrum(d))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("capped", [False, True])
def test_cylinder_mesh_matches_jax(capped):
    from mitsuba_tpu.models.shapes import cylinder_mesh as jcylinder
    from mitsuba_tpu_torch.models.shapes import cylinder_mesh

    m = np.diag([2.0, 1.0, 1.0, 1.0]).astype(np.float32)
    m[:3, 3] = [0.1, 0.2, 0.3]
    for got, want in zip(cylinder_mesh(12, [0, 0, 0], [0.3, 0.5, 1.0], 0.7,
                                       m, capped),
                         jcylinder(12, [0, 0, 0], [0.3, 0.5, 1.0], 0.7, m,
                                   capped)):
        assert np.array_equal(got, want)


def test_render_takes_scene_integrator():
    """``render(scene)`` renders with the scene's own integrator and its
    sampler's sample count; a scene without one raises."""
    scene = load_dict(cornell_box_dict(8, 8, 3), device="cpu")
    assert isinstance(scene.integrator, PathIntegrator)
    assert scene.integrator.max_depth == 8
    assert scene.sensor.sampler.sample_count == 3
    own = render(scene, seed=SEED, device="cpu")
    assert torch.equal(own, render(scene, PathIntegrator(8, 5), SEED, 3,
                                   device="cpu"))
    scene.integrator = None
    with pytest.raises(ValueError, match="integrator"):
        render(scene, device="cpu")


@pytest.mark.parametrize("variant", ["point_spot", "constant",
                                     "directional"])
def test_megapath_falls_back_for_delta_lights(variant, caplog):
    """MegakernelPathIntegrator logs its fallback, naming the lights, and
    gives the wavefront PathIntegrator's image; strict raises."""
    import logging

    from mitsuba_tpu_torch import MegakernelPathIntegrator

    scene = load_dict(delta_lights_dict(8, 8, 2, variant), device="cpu")
    with caplog.at_level(logging.INFO, "mitsuba_tpu_torch"):
        mega = render(scene, MegakernelPathIntegrator(4, 3), SEED, 2,
                      device="cpu")
    assert "falling back" in caplog.text
    assert type(scene.emitters[-1]).__name__ in caplog.text
    assert torch.equal(mega, render(scene, PathIntegrator(4, 3), SEED, 2,
                                    device="cpu"))
    with pytest.raises(ValueError, match="do not sample"):
        render(scene, MegakernelPathIntegrator(4, 3, strict=True), SEED, 2,
               device="cpu")


def test_particle_tracer_from_delta_lights():
    """The particle tracer starts paths from the point and spot lights
    (and the area light) of a loaded scene."""
    scene = load_dict(delta_lights_dict(8, 8, 2, "point_spot"), device="cpu")
    img = render(scene, ParticleTracerIntegrator(4, 3), SEED, 2,
                 device="cpu")
    assert torch.isfinite(img).all() and float(img.mean()) > 0


@pytest.mark.parametrize("kind,t,item", [
    ("bsdf", "principled", 6), ("bsdf", "polarizer", 7),
    ("shape", "blender", 8), ("sensor", "thinlens", 6),
    ("integrator", "volpath", 7), ("integrator", "aov", 6),
    ("sampler", "stratified", 6), ("film", "specfilm", 6),
    ("texture", "checkerboard", 6), ("medium", "homogeneous", 7)])
def test_unported_types_raise(kind, t, item):
    """A plugin type outside the port raises NotImplementedError citing
    the item of ROADMAP.md's Queue 1 that ports it."""
    d = cornell_box_dict(4, 4, 1)
    if kind == "bsdf":
        d["odd"] = {"type": t}
    elif kind == "shape":
        d["odd"] = {"type": t}
    elif kind in ("sensor", "integrator", "medium"):
        d[kind] = {"type": t}
    elif kind in ("sampler", "film"):
        d["sensor"] = dict(d["sensor"], **{kind: {"type": t}})
    else:
        d["white"] = {"type": "diffuse", "reflectance": {"type": t}}
    with pytest.raises(NotImplementedError,
                       match=rf"Queue 1, item {item}\b"):
        load_dict(d, device="cpu")


def test_loader_repairs_of_the_reference(tmp_path):
    """Where the JAX loader is at fault the port loads what it should
    (ROADMAP.md Queue 3): an OBJ without normals under a to_world stays
    flat (JAX gives it zero vertex normals, smooth-shaded), and a
    spectrum-valued reflectance is a constant texture (JAX raises)."""
    path = tmp_path / "t.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    d = {"type": "scene",
         "m": {"type": "obj", "filename": str(path),
               "to_world": np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32),
               "bsdf": {"type": "diffuse",
                        "reflectance": {"type": "spectrum", "value": 0.25}}}}
    jm = jload_dict({"type": "scene", "m": {k: v for k, v in d["m"].items()
                                            if k != "bsdf"}}).meshes[0]
    assert not np.asarray(jm.normals).any()
    scene = load_dict(d, device="cpu")
    assert scene.meshes[0].normals is None
    np.testing.assert_array_equal(scene.meshes[0].vertices.numpy(),
                                  np.asarray(jm.vertices))
    assert torch.equal(scene.bsdfs[0].reflectance.value,
                       torch.full((3,), 0.25))


def test_cli_writes_the_render(tmp_path):
    """``python -m mitsuba_tpu_torch scene.xml -o out.exr --device cpu``
    writes the EXR of ``render(load_file(...))``, bit for bit."""
    path = tmp_path / "scene.xml"
    path.write_text(_XML)
    out = tmp_path / "out.exr"
    assert main([str(path), "-o", str(out), "-D", "spp=2", "--seed", "5",
                 "--device", "cpu"]) == 0
    want = render(load_file(str(path), spp=2, device="cpu"), seed=5,
                  device="cpu")
    assert np.array_equal(read_image(out), want.numpy())
    if not torch.cuda.is_available():   # the GPU by default, or a failure
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([str(path), "-o", str(out)])


def test_lens_camera_and_sanity_scene():
    """A ``realisticlens`` sensor loads through ``make_lens_camera`` and
    renders; ``single_emitter_plane`` renders lit."""
    from mitsuba_tpu_torch.lens.camera import RealisticLensCamera
    from mitsuba_tpu_torch.utils.scenes import single_emitter_plane

    d = cornell_box_dict(8, 8, 1)
    d["sensor"] = dict(d["sensor"], type="realisticlens",
                       lens_design="singlet", object_distance=3.9)
    scene = load_dict(d, device="cpu")
    assert isinstance(scene.sensor, RealisticLensCamera)
    assert torch.isfinite(render(scene, seed=SEED, device="cpu")).all()
    plane = single_emitter_plane(8, 8, device="cpu")
    img = render(plane, PathIntegrator(3, 5), SEED, 2, device="cpu")
    assert float(img.mean()) > 0
