"""The port's threefry key chain (digital_earth_tpu_torch/ops/rng.py) is bit
for bit JAX's fold_in / uniform under jax_threefry_partitionable=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.ops import rng as jrng
from digital_earth_tpu_torch.ops import rng as trng

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

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


# edge keys: k0 = k1, ks[2] = k0 ^ k1 ^ 0x1BD11BDA = 0, one word 0 or all
# ones; edge data and counters: 0, 1, the sign bit's edges, 2^32 - 1
_PARITY = 0x1BD11BDA
EDGE_KEYS = ([(v, v) for v in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF)]
             + [(a, a ^ _PARITY) for a in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 0x12345678)]
             + [(0, 0xFFFFFFFF), (0xFFFFFFFF, 0), (_PARITY, 0), (0, _PARITY)])
EDGE_DATA = (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)


def _edge_keys():
    k = np.array(EDGE_KEYS, dtype=np.uint32)
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


@pytest.mark.parametrize("data", EDGE_DATA)
def test_fold_and_uniform_at_edge_keys(data):
    """fold and uniform from keys whose words are equal or whose parity word
    ks[2] is 0, at edge data, bit for bit jax.random.fold_in / uniform."""
    jk, tk = _edge_keys()
    want = np.asarray(jrng.fold(jk, jnp.uint32(data)))
    got = trng.fold(tk, data)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    want_u = np.asarray(jrng.uniform(jnp.asarray(want), (12,)))
    np.testing.assert_array_equal(trng.uniform(got, (12,)).numpy().view(np.uint32),
                                  want_u.view(np.uint32))
    np.testing.assert_array_equal(
        trng.uniform(tk, (12,)).numpy().view(np.uint32),
        np.asarray(jrng.uniform(jk, (12,))).view(np.uint32))


@pytest.mark.parametrize("counter", EDGE_DATA)
def test_threefry_words_at_edge_counters(counter):
    """The twin's threefry2x32 at the counter (0, c) against JAX's own
    threefry_2x32 for every edge key, and uniform_at's draw the word y0 ^ y1
    of it: counters past what uniform(key, shape) reaches."""
    from jax.extend.random import threefry_2x32

    jk, tk = _edge_keys()
    for i in range(len(EDGE_KEYS)):
        y = np.asarray(threefry_2x32(jk[i], jnp.asarray([0, counter], dtype=jnp.uint32)))
        got = trng.threefry2x32(tk[i, 0], tk[i, 1], torch.tensor(0), torch.tensor(counter))
        assert [int(got[0]), int(got[1])] == [int(y[0]), int(y[1])]
        bits = np.uint32(y[0] ^ y[1])
        want = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
        u = trng.uniform_at(tk[i], counter).numpy()
        assert u.view(np.uint32) == np.float32(want).view(np.uint32)


def test_lane_keys_at_edge_ids():
    """lane_keys of edge base keys over edge lane ids, bit for bit
    jax.random.fold_in per id."""
    ids = np.array(EDGE_DATA, dtype=np.uint32)
    jk, tk = _edge_keys()
    for i in range(len(EDGE_KEYS)):
        want = np.asarray(jrng.lane_keys(jk[i], jnp.asarray(ids)))
        got = trng.lane_keys(tk[i], torch.from_numpy(ids.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
