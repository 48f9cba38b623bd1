"""The fork's lens package (mitsuba_tpu/lens/ of the JAX package): the
realistic-lens camera (``camera.py``: ``RealisticLensCamera``,
``make_lens_camera``, autofocus, the exit-pupil table; its interfaces in
``elements.py``, the 15 named designs in ``designs.py``, the dispersive
glasses in ``materials.py``) and the lens-design toolkit (optimizable
surfaces, the lens system and its paraxial analysis, the spot losses and
the ``DesignProblem`` optimization loop)."""
from .camera import (RealisticLensCamera, compute_exit_pupil_lut,
                     focus_thick_lens, make_lens_camera,
                     make_realistic_lens_camera, thick_lens_approximation)
from .design import DesignProblem, FieldSource, accumulate_sensor_grads
from .designs import build_design, build_lens_from_data
from .elements import (ApertureStop, AsphericalLens, PlanoLens, SpheroidLens,
                       offset_element)
from .lens_system import LensMaterial, LensSystem
from .losses import rms_loss, rms_loss_and_center
from .materials import AIR, NBK7, DispersiveMaterial
from .surfaces import ConicSurface, EvenAsphericSurface

__all__ = ["AIR", "ApertureStop", "AsphericalLens", "ConicSurface",
           "DesignProblem", "DispersiveMaterial", "EvenAsphericSurface",
           "FieldSource", "LensMaterial", "LensSystem", "NBK7", "PlanoLens",
           "RealisticLensCamera", "SpheroidLens", "accumulate_sensor_grads",
           "build_design", "build_lens_from_data", "compute_exit_pupil_lut",
           "focus_thick_lens", "make_lens_camera",
           "make_realistic_lens_camera", "offset_element", "rms_loss",
           "rms_loss_and_center", "thick_lens_approximation"]
