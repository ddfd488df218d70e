"""The port's threefry key chain (digital_earth_tpu_torch/ops/rng.py) is bit
for bit JAX's fold_in / uniform under jax_threefry_partitionable=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.ops import rng as jrng
from digital_earth_tpu_torch.ops import rng as trng

N = 4096


@pytest.fixture(scope="module")
def keys():
    ids = np.random.default_rng(0).integers(0, 2**31 - 1, N)
    jk = jrng.lane_keys(jax.random.fold_in(jax.random.PRNGKey(3), 17), jnp.asarray(ids))
    tk = trng.lane_keys(trng.fold(trng.prng_key(3, "cpu"), 17), torch.from_numpy(ids))
    return jk, tk


def test_prng_key_and_fold_in():
    for seed, data in [(0, 0), (0, 5), (7, 0xFFFFFFFF), (123456, 2**31)]:
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        got = trng.fold(trng.prng_key(seed, "cpu"), data).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_lane_keys_bit_equal(keys):
    jk, tk = keys
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("shape", [(), (2,), (3,), (3, 4)])
def test_uniform_bit_equal(keys, shape):
    jk, tk = keys
    for data in (0, 1, 250):
        want = np.asarray(jrng.uniform(jrng.fold(jk, data), shape))
        got = trng.uniform(trng.fold(tk, data), shape).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_as_lane_keys_expands_one_key():
    want = np.asarray(jrng.as_lane_keys(jax.random.PRNGKey(9), 64))
    got = trng.as_lane_keys(trng.prng_key(9, "cpu"), 64).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    with pytest.raises(ValueError):
        trng.as_lane_keys(torch.zeros((5, 2), dtype=torch.int64), 4)
