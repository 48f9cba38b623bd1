"""The lens-design examples of the JAX package (examples/*.py), as modules
of the port: ``python -m mitsuba_tpu_torch.examples.<name>``."""
