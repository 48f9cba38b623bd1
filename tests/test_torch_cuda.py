"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one.  They
import only the port, so they run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from mitsuba_tpu_torch import cornell_box
from mitsuba_tpu_torch.models.integrators import sample_rays
from mitsuba_tpu_torch.ops.megakernel import (megakernel_trace,
                                              megakernel_trace_plain,
                                              pack_scene)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = cornell_box(32, 32, device="cuda")
    ray, _, _, lane = sample_rays(scene, 5, 4)
    tris, light, n_faces, n_lights = pack_scene(scene)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    return ((tris, light, lane, ray.o, ray.d, active, 5),
            dict(max_depth=6, rr_depth=5, n_faces=n_faces, n_lights=n_lights))


def test_megakernel_matches_plain(cuda_inputs):
    """Per-lane bar of tests/test_megakernel.py: rounding may flip a rare
    russian-roulette or visibility decision, nothing more."""
    args, kw = cuda_inputs
    before = megakernel_trace.launches
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel_trace.launches == before + 1
    ref = megakernel_trace_plain(*args, **kw)
    assert torch.isfinite(got).all()
    close = torch.isclose(got, ref, rtol=2e-3, atol=2e-3).all(dim=-1)
    assert close.float().mean() >= 0.995
    assert abs(got.mean() - ref.mean()) / ref.mean() < 2e-3


def test_megakernel_rejects_bad_inputs(cuda_inputs):
    args, kw = cuda_inputs
    lane64 = args[2].to(torch.int64)
    with pytest.raises(ValueError):
        megakernel_trace(*args[:2], lane64, *args[3:], **kw)
