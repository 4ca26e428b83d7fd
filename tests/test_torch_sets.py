"""The port's sets/ops.py against gms_tpu.sets.ops on seeded padded rows.
Every comparison is exact (integer and boolean arrays)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.sets import ops as jops

from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.sets import ops

torch.set_num_threads(1)


def padded_rows(seed, batch, width, universe):
    """int32[batch, width] sorted distinct rows with SENTINEL tails."""
    rng = np.random.default_rng(seed)
    out = np.full((batch, width), SENTINEL, dtype=np.int32)
    for i in range(batch):
        k = int(rng.integers(0, width + 1))
        out[i, :k] = np.sort(rng.choice(universe, size=k, replace=False))
    return out


CASES = [(0, 16, 16, 40), (1, 8, 64, 100), (2, 32, 5, 12), (3, 4, 128, 1000)]


def _pair(seed, batch, wa, universe, wb=None):
    a = padded_rows(seed, batch, wa, universe)
    b = padded_rows(seed + 100, batch, wb or max(wa // 2, 1), universe)
    return a, b


@pytest.mark.parametrize("method", ["compare", "searchsorted", "auto"])
@pytest.mark.parametrize("case", CASES)
def test_member_and_counts(case, method):
    a, b = _pair(*case)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(ops.member(ta, tb, method=method).numpy(),
                          np.asarray(jops.member(ja, jb, method=method)))
    got = ops.intersect_count(ta, tb, method=method)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(jops.intersect_count(ja, jb, method=method)))
    assert np.array_equal(ops.intersect(ta, tb, method=method).numpy(),
                          np.asarray(jops.intersect(ja, jb, method=method)))
    assert np.array_equal(ops.difference(ta, tb, method=method).numpy(),
                          np.asarray(jops.difference(ja, jb, method=method)))


@pytest.mark.parametrize("case", CASES)
def test_union_and_derived_counts(case):
    a, b = _pair(*case)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(ops.union(ta, tb).numpy(),
                          np.asarray(jops.union(ja, jb)))
    assert np.array_equal(ops.union_count(ta, tb).numpy(),
                          np.asarray(jops.union_count(ja, jb)))
    assert np.array_equal(ops.difference_count(ta, tb).numpy(),
                          np.asarray(jops.difference_count(ja, jb)))
    assert np.array_equal(ops.cardinality(ta).numpy(),
                          np.asarray(jops.cardinality(ja)))
    assert np.array_equal(ops.valid_mask(ta).numpy(),
                          np.asarray(jops.valid_mask(ja)))


@pytest.mark.parametrize("case", CASES)
def test_contains_add_remove(case):
    seed, batch, width, universe = case
    rows = padded_rows(seed, batch, width, universe)
    rng = np.random.default_rng(seed + 7)
    # probes: half drawn from the rows, half random, one SENTINEL
    x = rng.integers(0, universe, batch).astype(np.int32)
    for i in range(0, batch, 2):
        real = rows[i][rows[i] != SENTINEL]
        if len(real):
            x[i] = real[rng.integers(len(real))]
    x[-1] = SENTINEL
    tr, tx = torch.from_numpy(rows), torch.from_numpy(x)
    jr, jx = jnp.asarray(rows), jnp.asarray(x)
    assert np.array_equal(ops.contains(tr, tx).numpy(),
                          np.asarray(jops.contains(jr, jx)))
    assert np.array_equal(ops.add(tr, tx).numpy(), np.asarray(jops.add(jr, jx)))
    assert np.array_equal(ops.remove(tr, tx).numpy(),
                          np.asarray(jops.remove(jr, jx)))


def test_row_helpers():
    row = ops.from_array([5, 1, 3], 6, device="cpu")
    assert row.tolist() == [1, 3, 5] + [int(SENTINEL)] * 3
    assert np.array_equal(row.numpy(), np.asarray(jops.from_array([5, 1, 3], 6)))
    assert ops.to_array(row).tolist() == [1, 3, 5]


def test_unknown_method_raises():
    a = torch.from_numpy(padded_rows(0, 2, 4, 10))
    with pytest.raises(ValueError):
        ops.member(a, a, method="merge")
