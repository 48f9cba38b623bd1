"""The port's PCG3D stream is bit-exact with mitsuba_tpu.core.rng."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu_torch.core import rng as trng


def _lanes():
    r = np.random.default_rng(11)
    edges = np.array([0, 1, 2, 255, 256, 2**24 - 1, 2**24, 2**31 - 2,
                      2**31 - 1], np.int64)
    return np.concatenate([edges, r.integers(0, 2**31, 2048)]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF])
def test_sample_1d_2d_bit_exact(seed):
    lanes = _lanes()[:, None]                      # (L, 1)
    dims = np.arange(61, dtype=np.int32)[None, :]  # (1, 61)
    j1 = np.asarray(jrng.sample_1d(jnp.uint32(seed), jnp.asarray(lanes),
                                   jnp.asarray(dims)))
    j2 = np.asarray(jrng.sample_2d(jnp.uint32(seed), jnp.asarray(lanes),
                                   jnp.asarray(dims)))
    t1 = trng.sample_1d(seed, torch.as_tensor(lanes), torch.as_tensor(dims))
    t2 = trng.sample_2d(seed, torch.as_tensor(lanes), torch.as_tensor(dims))
    assert t1.dtype == torch.float32 and t2.shape == (lanes.shape[0], 61, 2)
    np.testing.assert_array_equal(t1.numpy(), j1)
    np.testing.assert_array_equal(t2.numpy(), j2)


def test_integer_dim_and_seed_arguments():
    """Python ints for dim and seed give the same stream as tensors."""
    lanes = torch.as_tensor(_lanes())
    a = trng.sample_2d(3, lanes, 17)
    b = trng.sample_2d(torch.tensor(3), lanes, torch.tensor(17))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(trng.sample_1d(3, lanes, 17).numpy(),
                                  a[:, 0].numpy())
