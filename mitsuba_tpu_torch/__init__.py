"""mitsuba_tpu_torch: the PyTorch/CUDA port of mitsuba_tpu.

The JAX package ``mitsuba_tpu`` stays the reference; this package keeps
its layout and names, runs on an NVIDIA GPU (sm_90a) with hand-written
CUDA kernels built by nvcc at first use, and imports neither JAX nor
``mitsuba_tpu``.  Entry points run on the GPU unless the caller passes
``device="cpu"``, where every kernel runs as its plain PyTorch version.

Ported so far, for scenes of constant or bitmap-textured diffuse,
smooth and GGX rough conductor, dielectric and plastic BSDFs (each also
two-sided, but the dielectrics) with area lights and a lat-long
environment map, flat or smooth shading and the independent sampler
(BASELINE configs 1 and 2, the surfaces of config 3):

- the megakernel path for one area light, one environment map or both:
  the brute kernel up to 1024 faces, ``render(cornell_box(),
  MegakernelPathIntegrator())``, and the BVH kernels above,
  ``render(big_scene(), MegakernelPathIntegrator())``;
- the wavefront ``PathIntegrator`` over the brute ``intersect_packed``
  kernel up to 1024 faces and the BVH ``packet_closest_hit`` /
  ``packet_any_hit`` kernels above, e.g. ``render(cornell_box(),
  PathIntegrator())``; ``MegakernelPathIntegrator`` falls back to it for
  a scene outside the megakernel subset (two lights, say) or whose BVH
  is deeper than the BVH kernels' walk takes;
- the ``DirectIntegrator``, over the same hit queries as the wavefront;
- differentiable rendering (BASELINE config 3): ``prb_render`` with the
  ``PRBIntegrator`` (path-replay backpropagation as a
  ``torch.autograd.Function``), ``prb_render_forward``, the
  ``PRBBasicIntegrator``, scene parameters (``utils/params.py``) and the
  JAX package's functional optimizers (``utils/optimizers.py``);
- lens design (BASELINE config 5): the ``ParticleTracerIntegrator``
  (monochrome or spectral, through ``DispersiveDielectric`` glass, from
  area lights and collimated ``DirectionalAreaEmitter`` sources) and the
  ``lens`` package (``LensSystem``, ``DesignProblem``); the examples run
  as ``python -m mitsuba_tpu_torch.examples.doublet_achromat_design`` and
  ``...triplet_efl_design``.  A scene's BVH is refitted to its current
  vertices on every render;
- the realistic-lens camera (``make_lens_camera``: the 15 named designs,
  autofocus, the exit-pupil table, spectral or RGB), which every
  integrator above renders through, e.g. ``render(dataclasses.replace(
  cornell_box(), sensor=make_lens_camera("gauss", to_world=...)),
  MegakernelPathIntegrator())``;
- camera-pose, silhouette and shadow gradients (BASELINE config 4):
  ``prb_projective_render`` with ``PathProjectiveIntegrator`` or
  ``DirectProjectiveIntegrator`` (PRB plus the primary silhouette
  boundary term, grid-guided edge sampling over
  ``build_silhouette_edges``, plus, on a scene lit by one constant area
  light, the shadow-boundary term ``indirect_boundary_grads``: uniform,
  ``OcSpaceDistr``-guided or projection-seeded, its shadows seen through
  ``indirect_depth`` - 1 bounces) and ``LargeSteps`` for vertex
  optimisation;
- exact analytic spheres, disks and cylinders (``models/analytic.py``,
  ``make_scene(..., analytic=build_analytic(prims))``, e.g.
  ``render(analytic_cornell(), PathIntegrator())``), an area light on an
  analytic sphere, and their exact silhouettes in
  ``prb_projective_render`` (``analytic_boundary_grads``).  They go
  through the wavefront path; ``MegakernelPathIntegrator`` falls back to
  it;
- exact linear and cubic B-spline curve prims (``analytic_prim`` of a
  ``linearcurve`` / ``bsplinecurve`` dict), the SDF grid (``SDFGrid``,
  ``make_scene(..., sdf=...)``) and two-level instancing
  (``InstancedGroup``, ``make_scene(..., instances=[...])``, whose groups
  are walked in object space by the brute kernel or the BVH kernels), e.g.
  ``render(curves_cornell(), PathIntegrator())``, ``sdf_cornell()`` and
  ``instanced_cornell()``, through the wavefront integrators,
  ``prb_render`` and ``prb_projective_render`` (no boundary term of
  their own, as in the JAX package);
- scene files and the command line: ``load_dict`` of a Mitsuba-style dict
  (``load_dict(cornell_box_dict())``), ``load_file`` of an XML file
  (``utils/xml.py``, with ``$name`` defaults and the pre-2.0 upgrade),
  OBJ / PLY / serialized meshes (``utils/mesh_io.py``) and PNG / PFM /
  HDR / EXR images (``utils/bitmap.py``, codecs of its own), each on the
  GPU unless ``device="cpu"``; ``render(scene)`` with the scene's own
  integrator (``DepthIntegrator`` among them); ``python -m
  mitsuba_tpu_torch scene.xml -o out.exr [--device cpu]``.  A loaded
  scene may hold point, spot, projector, constant and directional lights
  (``models/emitters.py``): delta lights are reached by NEE alone, with
  MIS weight 1, the infinite ones take the scene's bounding sphere, the
  particle tracer starts paths from every emitter, and
  ``MegakernelPathIntegrator`` falls back to the wavefront path for
  them, logged.
"""
from .convert import lens_camera_from_numpy, scene_from_numpy
from .device import resolve_device
from .lens.camera import make_lens_camera
from .models.analytic import AnalyticShapes, analytic_prim, build_analytic
from .models.instancing import InstancedGroup
from .models.sdf import SDFGrid, sphere_sdf_grid
from .models.integrators import (DepthIntegrator, DirectIntegrator,
                                 DirectProjectiveIntegrator,
                                 MegakernelPathIntegrator,
                                 ParticleTracerIntegrator, PathIntegrator,
                                 PathProjectiveIntegrator, PRBBasicIntegrator,
                                 PRBIntegrator, analytic_boundary_grads,
                                 build_silhouette_edges,
                                 indirect_boundary_grads,
                                 prb_projective_render, prb_render,
                                 prb_render_forward, render, sample_rays)
from .models.integrators.guiding import OcSpaceDistr
from .models.integrators.projection import (build_face_adjacency,
                                            hybrid_projection, mesh_jump,
                                            mesh_walk, project_seed_points,
                                            silhouette_projection)
from .utils.largesteps import LargeSteps
from .utils.load import load_dict
from .utils.scenes import (analytic_cornell, big_scene, cornell_box,
                           cornell_box_dict, curves_cornell, instanced_cornell,
                           sdf_cornell)
from .utils.xml import load_file

__all__ = ["AnalyticShapes", "DepthIntegrator", "DirectIntegrator",
           "DirectProjectiveIntegrator", "InstancedGroup", "LargeSteps",
           "MegakernelPathIntegrator", "OcSpaceDistr",
           "ParticleTracerIntegrator", "PathIntegrator",
           "PathProjectiveIntegrator", "PRBBasicIntegrator", "PRBIntegrator",
           "SDFGrid", "curves_cornell", "instanced_cornell", "sdf_cornell",
           "sphere_sdf_grid",
           "analytic_boundary_grads", "analytic_cornell", "analytic_prim",
           "big_scene", "build_analytic", "build_face_adjacency", "build_silhouette_edges",
           "cornell_box", "cornell_box_dict", "hybrid_projection", "indirect_boundary_grads",
           "lens_camera_from_numpy", "load_dict", "load_file",
           "make_lens_camera", "mesh_jump",
           "mesh_walk", "prb_projective_render", "prb_render",
           "prb_render_forward", "project_seed_points", "render",
           "resolve_device", "sample_rays", "scene_from_numpy",
           "silhouette_projection"]
