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
from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

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
    with pytest.raises(TypeError):
        kc.build_local_adj(_i32(8, 4), _i32(3).long(), w_words=1)
    with pytest.raises(ValueError, match="w_words"):
        kc.build_local_adj(_i32(8, 4), _i32(3), w_words=0)
    with pytest.raises(ValueError, match="32\\*WW"):
        kc.kclique_dense_count(_i32(2, 16, 1), k=4)
    with pytest.raises(ValueError, match="does not match"):
        kc.kc_stack_count(_i32(2, 32, 1), _i32(3, 1), k=6)
    with pytest.raises(ValueError, match="k must be >= 5"):
        kc.kc_stack_count(_i32(2, 32, 1), _i32(2, 1), k=4)


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


def _launched(name, fn, launches=tc.LAUNCHES):
    before = launches[name]
    out = fn()
    assert launches[name] == before + 1
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


def _padded_rows(rng, V, D, n, max_len):
    """int32[V, D]: rows 0..n-1 strictly ascending over [0, n) with a
    SENTINEL tail, the rest all SENTINEL (the padded layout)."""
    nbr = np.full((V, D), SENTINEL, dtype=np.int32)
    for v in range(n):
        k = int(rng.integers(0, max_len + 1))
        nbr[v, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return nbr


def _sparse_bits(rng, shape, p):
    """int32 words whose bits are set with probability p."""
    bits = rng.random((*shape[:-1], shape[-1] * 32)) < p
    words = np.packbits(bits.reshape(-1, 8), bitorder="little")
    return torch.from_numpy(words.view(np.int32).reshape(shape).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", [(1, 96), (3, 64), (32, 160)])
def test_local_adj_on_card(card, ww, D):
    # W < D, W > D and W = 1024 > D; roots include pad and negative ids
    rng = np.random.default_rng(ww * D)
    V, n = 300, 290
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    roots = rng.integers(0, n, 70).astype(np.int32)
    roots[-3:] = (V, V + 11, -2)
    roots = torch.from_numpy(roots).to(card)
    adj, s0 = _launched("build_local_adj", lambda: kc.build_local_adj(
        nbr, roots, w_words=ww), kc.LAUNCHES)
    padj, ps0 = kc.build_local_adj_plain(nbr, roots, w_words=ww)
    assert torch.equal(adj, padj) and torch.equal(s0, ps0)
    assert adj.any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("C,ww,p", [(40, 1, 0.3), (9, 5, 0.1), (3, 32, 0.03),
                                    (2, 64, 0.03)])
def test_dense_count_on_card(card, k, C, ww, p):
    # ww=64 (W=2048) reads A from device memory, the others from shared
    # memory, ww=32 (128 KB) above the 48 KB default
    rng = np.random.default_rng(C * ww + k)
    adj = _sparse_bits(rng, (C, 32 * ww, ww), p).to(card)
    got = _launched("kclique_dense_count",
                    lambda: kc.kclique_dense_count(adj, k=k), kc.LAUNCHES)
    assert int(got) == int(kc.kclique_dense_count_plain(adj, k=k)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 6, 8])
def test_stack_count_on_card(card, k):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    pg, chunks = kc.plan_chunks(g, k, device=card, root_chunk=64)
    for chunk, ww in chunks[-3:]:
        for w in (ww, 2 * ww):  # the tier's width and a wider one
            adj, s0 = kc.build_local_adj(pg.nbr, chunk, w_words=w)
            got = _launched("kc_stack_count",
                            lambda: kc.kc_stack_count(adj, s0, k=k),
                            kc.LAUNCHES)
            assert int(got) == int(kc.kc_stack_count_plain(adj, s0, k=k))
    # random bits at W = 1024
    rng = np.random.default_rng(k)
    adj = _sparse_bits(rng, (3, 1024, 32), 0.02).to(card)
    s0 = _sparse_bits(rng, (3, 32), 0.3).to(card)
    got = _launched("kc_stack_count", lambda: kc.kc_stack_count(adj, s0, k=k),
                    kc.LAUNCHES)
    assert int(got) == int(kc.kc_stack_count_plain(adj, s0, k=k))
