"""The fork's lens-design toolkit (mitsuba_tpu/lens/ of the JAX package):
optimizable surfaces, the lens system and its paraxial analysis, the
spot losses and the ``DesignProblem`` optimization loop.  The
realistic-lens camera (``camera.py``, ``elements.py``, ``designs.py``,
``materials.py``) is not ported yet (ROADMAP.md, Queue 1, item 4b)."""
from .design import DesignProblem, FieldSource, accumulate_sensor_grads
from .lens_system import LensMaterial, LensSystem
from .losses import rms_loss, rms_loss_and_center
from .surfaces import ConicSurface, EvenAsphericSurface

__all__ = ["ConicSurface", "DesignProblem", "EvenAsphericSurface",
           "FieldSource", "LensMaterial", "LensSystem",
           "accumulate_sensor_grads", "rms_loss", "rms_loss_and_center"]
