"""gms_tpu_torch/prng.py against jax.random, bit for bit, with x64 on as
gms_tpu sets it (importing gms_tpu turns it on): keys, fold_in, split, the
32- and 64-bit words and randint over many seeds, shapes and per-element
maxval values, maxval <= minval included. Exact: every value is an
integer."""

import numpy as np
import pytest
import torch

import gms_tpu  # noqa: F401  (turns jax_enable_x64 on, as gms_tpu runs)
import jax
import jax.numpy as jnp

from gms_tpu_torch import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 5, 42, 1000, 123456789, (1 << 40) + 7, -3, -(1 << 35)]


def _key_words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_x64_is_on():
    assert jax.config.jax_enable_x64
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    pk = prng.key(seed, device="cpu")
    assert np.array_equal(_key_words(jax.random.key(seed)), pk.numpy())
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.PRNGKey(seed, device="cpu").numpy())
    for data in (0, 1, 17, 127, 1 << 20, (1 << 31) + 5, (1 << 32) - 1):
        want = _key_words(jax.random.fold_in(jax.random.key(seed), data))
        assert np.array_equal(want, prng.fold_in(pk, data).numpy()), data
    for num in (1, 2, 3, 8):
        want = _key_words(jax.random.split(jax.random.key(seed), num))
        assert np.array_equal(want, prng.split(pk, num).numpy()), num


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (5, 7), (2, 3, 4), (1000,)])
def test_random_bits(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    pk = prng.fold_in(prng.key(seed, device="cpu"), 3)
    want32 = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    assert np.array_equal(want32.astype(np.int64),
                          prng.random_bits(pk, 32, shape).numpy())
    want64 = np.asarray(jax.random.bits(k, shape, jnp.uint64)).view(np.int64)
    assert np.array_equal(want64, prng.random_bits(pk, 64, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("high", [1, 2, 300, 70_000, (1 << 31) - 1])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_randint_per_element_maxval(seed, high, dtype):
    """Per-element maxval from -3 to high, so maxval <= minval (span 1)
    shows up beside spans whose 32-bit products wrap (span > 2^16)."""
    rng = np.random.default_rng(abs(seed) % 1000 + high)
    mx = rng.integers(-3, high + 1, 1000).astype(dtype)
    k = jax.random.fold_in(jax.random.key(seed), 11)
    pk = prng.fold_in(prng.key(seed, device="cpu"), 11)
    want = np.asarray(jax.random.randint(k, (1000,), 0, jnp.asarray(mx),
                                         dtype=getattr(jnp, dtype)))
    got = prng.randint(pk, (1000,), 0, torch.from_numpy(mx),
                       getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_randint_scalar_bounds_and_shapes(seed):
    k, pk = jax.random.key(seed), prng.key(seed, device="cpu")
    for shape, lo, hi in (((128,), 0, 77), ((4, 8), 5, 9), ((3,), 4, 4),
                          ((6,), 9, 2), ((50,), -10, 10)):
        for dtype in ("int32", "int64"):
            want = np.asarray(jax.random.randint(k, shape, lo, hi,
                                                 dtype=getattr(jnp, dtype)))
            got = prng.randint(pk, shape, lo, hi, getattr(torch, dtype))
            assert np.array_equal(want, got.numpy()), (shape, lo, hi, dtype)
    # jnp's default int (int64 with x64 on): gms_tpu's ADG and one-shot draws
    want = np.asarray(jax.random.randint(k, (128,), 0, 4096))
    assert want.dtype == np.int64
    assert np.array_equal(want, prng.randint(pk, (128,), 0, 4096,
                                             torch.int64).numpy())


def test_randint_from_bits_is_randint():
    pk = prng.key(9, device="cpu")
    draws = prng.randint_bits(pk, (500,), 64)
    mx = torch.arange(500) % 37
    assert torch.equal(prng.randint_from_bits(draws, 0, mx, 64),
                       prng.randint(pk, (500,), 0, mx, torch.int64))


def test_rejects_what_it_does_not_cover():
    pk = prng.key(0, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        prng.randint(pk, (4,), 0, 1 << 31, torch.int64)
    with pytest.raises(TypeError):
        prng.randint(pk, (4,), 0, 5, torch.int16)
    with pytest.raises(ValueError):
        prng.random_bits(pk, 16, (4,))
