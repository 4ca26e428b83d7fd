"""Kernel wrappers and the kernel build of the PyTorch port.

Here on any host: the wrappers' checks of device, dtype, shape and
contiguity, and the build's staleness rule and its refusal without nvcc.
On a card (marker `cuda`, skipped elsewhere): every CUDA kernel against its
plain PyTorch version, exactly, at awkward widths. This file imports neither
jax nor gms_tpu, so on a machine without jax it runs with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.graphs.tiles import SENTINEL

torch.set_num_threads(1)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        tc.count_tier_mat(_i32(4, 8).long(), _i32(4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        tc.count_tier_mat(_i32(8, 4).T, _i32(4, 8))
    with pytest.raises(ValueError, match="edge counts"):
        tc.count_tier_mat(_i32(4, 8), _i32(4, 9))
    with pytest.raises(ValueError, match="does not match"):
        tc.count_hub_groups_mat(_i32(3, 5), _i32(3, 2, 4))
    with pytest.raises(TypeError):
        tc.count_hub_groups_mat(_i32(3, 5), _i32(3, 5))
    with pytest.raises(ValueError, match="is not"):
        tc.count_hub_groups(_i32(4, 2), _i32(3), _i32(3, 5), chunk=1,
                            width=2, k=4)
    with pytest.raises(ValueError, match="do not match"):
        tc.count_dag_edges(_i32(8, 4), _i32(5, 2), _i32(4))
    with pytest.raises(ValueError, match="V_pad"):
        tc.build_hub_rows(_i32(8, 4), _i32(8), _i32(2), hub_words=1)
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tc.count_tier_mat(meta, meta)


def test_every_source_has_a_binding():
    sources = {p.stem for p in _kernels.CSRC.glob("*.cu")}
    assert sources == set(_kernels.SIGNATURES)


def test_build_staleness(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD", build)
    (csrc / "k.cu").write_text("")
    (csrc / "h.cuh").write_text("")
    assert _kernels._stale("k")              # never built
    lib = build / "libk.so"
    lib.write_text("")
    os.utime(csrc / "k.cu", (1, 1))
    os.utime(csrc / "h.cuh", (1, 1))
    assert not _kernels._stale("k")
    os.utime(csrc / "h.cuh", None)           # a header newer than the library
    os.utime(lib, (2, 2))
    assert _kernels._stale("k")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_columns(rng, width, n, universe):
    out = np.full((width, n), SENTINEL, dtype=np.int32)
    for e in range(n):
        k = int(rng.integers(0, width + 1))
        out[:k, e] = np.sort(rng.choice(universe, size=k, replace=False))
    return out


def _words(rng, shape):
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=shape,
                                         dtype=np.int64).astype(np.int32))


def _launched(name, fn):
    before = tc.LAUNCHES[name]
    out = fn()
    assert tc.LAUNCHES[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("wa,wb,E", [(16, 16, 1000), (3, 70, 257), (512, 512, 300)])
def test_tier_intersect_on_card(card, wa, wb, E):
    rng = np.random.default_rng(wa + wb + E)
    a = torch.from_numpy(_sorted_columns(rng, wa, E, 2 * wb)).to(card)
    b = torch.from_numpy(_sorted_columns(rng, wb, E, 2 * wb)).to(card)
    got = _launched("count_tier_mat", lambda: tc.count_tier_mat(a, b))
    assert int(got) == int(tc.count_tier_mat_plain(a, b, chunk=128))
    # gather mode over the same rows laid out as an adjacency
    d = max(wa, wb)
    nbr = torch.full((2 * E + 1, d), int(SENTINEL), dtype=torch.int32,
                     device=card)
    nbr[:E, :wa] = a.T
    nbr[E:2 * E, :wb] = b.T
    edges = torch.stack([torch.arange(E), torch.arange(E, 2 * E)], 1)
    edges = edges.to(torch.int32).to(card)
    valid = torch.ones(E, dtype=torch.int32, device=card)
    valid[-7:] = 0
    edges[-7:] = 0  # padding edges point at vertex 0 and add nothing
    got = _launched("count_dag_edges", lambda: tc.count_dag_edges(
        nbr, edges, valid, width_a=wa, width_b=wb))
    assert int(got) == int(tc.count_dag_edges_plain(
        nbr, edges, valid, chunk=64, width_a=wa, width_b=wb))


@pytest.mark.cuda
@pytest.mark.parametrize("G,K,W", [(50, 16, 16), (33, 64, 5), (7, 64, 532),
                                   (12, 16, 300)])
def test_hub_popcount_on_card(card, G, K, W):
    rng = np.random.default_rng(G * K + W)
    b = _words(rng, (G, W)).to(card)
    a = _words(rng, (G, K, W)).to(card)
    got = _launched("count_hub_groups_mat",
                    lambda: tc.count_hub_groups_mat(b, a))
    assert int(got) == int(tc.count_hub_groups_mat_plain(b, a, chunk=4))
    rows = _words(rng, (40, W + 3)).to(card)
    rows[-1] = 0
    b_ids = torch.from_numpy(rng.integers(0, 40, G).astype(np.int32)).to(card)
    nbrs = torch.from_numpy(rng.integers(0, 40, (G, K)).astype(np.int32)).to(card)
    got = _launched("count_hub_groups", lambda: tc.count_hub_groups(
        rows, b_ids, nbrs, chunk=8, width=W, k=K))
    assert int(got) == int(tc.count_hub_groups_plain(
        rows, b_ids, nbrs, chunk=8, width=W, k=K))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [1, 17])
def test_hub_rows_on_card(card, hw):
    rng = np.random.default_rng(hw)
    V, D, n = 200, 128, 150
    nbr = np.full((V, D), SENTINEL, dtype=np.int32)
    for v in range(n):
        k = int(rng.integers(0, D + 1))
        nbr[v, :k] = np.sort(rng.choice(n, size=k, replace=False))
    hub_id = np.full(V + 1, 32 * hw, dtype=np.int32)
    n_hub = min(32 * hw, n)
    hub_id[rng.choice(n, size=n_hub, replace=False)] = rng.permutation(n_hub)
    wide = rng.choice(n, size=60, replace=False).astype(np.int32)
    wide[-1] = V + 5  # clips to the guard row
    args = [torch.from_numpy(x).to(card) for x in (nbr, hub_id, wide)]
    got = _launched("build_hub_rows",
                    lambda: tc.build_hub_rows(*args, hub_words=hw))
    assert torch.equal(got, tc.build_hub_rows_plain(*args, hub_words=hw))
    assert got.any()
