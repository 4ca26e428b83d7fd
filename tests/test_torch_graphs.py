"""Host graph substrate of the PyTorch port against gms_tpu, element for
element: generators, readers, builder, orientation, padded layout, checks.
All comparisons are exact (integer arrays)."""

import numpy as np
import pytest
import torch

from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io import builder as jbuilder
from gms_tpu.io import generators as jgen
from gms_tpu.io import readers as jreaders
from gms_tpu.preprocessing import orient as jorient

from gms_tpu_torch.graphs.tiles import SENTINEL, PaddedGraph
from gms_tpu_torch.harness import checks
from gms_tpu_torch.io import builder, generators, readers
from gms_tpu_torch.preprocessing import orient

torch.set_num_threads(1)

FIXTURES = ["eppsteinExample", "micro", "smallRandom1", "tomitaExample",
            "triangles_1", "triangles_3"]
SCALES = [8, 9, 10]


def _pair(name, test_graph_dir):
    """(port graph, gms_tpu graph) for a fixture name or an RMAT scale."""
    if isinstance(name, int):
        el = generators.generate_rmat_el(name, 8, seed=name)
        return (builder.build_csr(el, num_nodes=1 << name),
                jbuilder.build_csr(el, num_nodes=1 << name))
    path = str(test_graph_dir / f"{name}.el")
    return readers.read_el(path), jreaders.read_el(path)


def _same_csr(a, b):
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert a.directed() == b.directed()


@pytest.mark.parametrize("scale", SCALES)
def test_rmat_edge_lists_equal(scale):
    assert np.array_equal(generators.generate_rmat_el(scale, 8, seed=3),
                          jgen.generate_rmat_el(scale, 8, seed=3))


@pytest.mark.parametrize("scale", SCALES)
def test_uniform_edge_lists_equal(scale):
    assert np.array_equal(generators.generate_uniform_el(scale, 8, seed=5),
                          jgen.generate_uniform_el(scale, 8, seed=5))


def test_generate_graph_equal():
    _same_csr(generators.generate_graph("kronecker", 9, 8),
              jgen.generate_graph("kronecker", 9, 8))
    _same_csr(generators.generate_graph("uniform", 9, 8),
              jgen.generate_graph("uniform", 9, 8))
    with pytest.raises(ValueError):
        generators.generate_graph("nope", 4)


@pytest.mark.parametrize("name", FIXTURES + SCALES)
def test_csr_equal(name, test_graph_dir):
    g, jg = _pair(name, test_graph_dir)
    _same_csr(g, jg)


@pytest.mark.parametrize("name", FIXTURES + SCALES)
def test_orientation_equal(name, test_graph_dir):
    g, jg = _pair(name, test_graph_dir)
    rank = orient.degree_rank(g)
    assert np.array_equal(rank, jorient.degree_rank(jg))
    assert np.array_equal(orient.id_rank(g), jorient.id_rank(jg))
    _same_csr(orient.orient(g, rank), jorient.orient(jg, rank))
    _same_csr(orient.orient(g), jorient.orient(jg))


@pytest.mark.parametrize("name", FIXTURES + SCALES)
def test_padded_equal(name, test_graph_dir):
    g, jg = _pair(name, test_graph_dir)
    dag = orient.orient(g, orient.degree_rank(g))
    pg = PaddedGraph.from_csr(dag, device="cpu")
    jpg = JPaddedGraph.from_csr(jorient.orient(jg, jorient.degree_rank(jg)))
    assert pg.nbr.dtype == torch.int32 and pg.deg.dtype == torch.int32
    assert np.array_equal(pg.nbr.numpy(), np.asarray(jpg.nbr))
    assert np.array_equal(pg.deg.numpy(), np.asarray(jpg.deg))
    assert (pg.num_nodes, pg.num_edges) == (jpg.num_nodes, jpg.num_edges)
    checks.validate_padded(pg.nbr, pg.deg, pg.num_nodes)
    vids = torch.arange(min(4, pg.v_pad), dtype=torch.int64)
    assert np.array_equal(pg.rows(vids).numpy(),
                          np.asarray(jpg.rows(vids.numpy())))
    assert np.array_equal(pg.degrees_of(vids).numpy(),
                          np.asarray(jpg.degrees_of(vids.numpy())))


def test_padded_options_equal():
    g = generators.generate_graph("kronecker", 8, 8)
    jg = jgen.generate_graph("kronecker", 8, 8)
    pg = PaddedGraph.from_csr(g, device="cpu", d_pad=300, v_pad=400)
    jpg = JPaddedGraph.from_csr(jg, d_pad=300, v_pad=400)
    assert pg.nbr.shape == (400, 384)
    assert np.array_equal(pg.nbr.numpy(), np.asarray(jpg.nbr))


def test_builder_helpers_equal():
    el = generators.generate_rmat_el(9, 8, seed=11)
    g, jg = builder.build_csr(el), jbuilder.build_csr(el)
    _same_csr(builder.relabel_by_degree(g), jbuilder.relabel_by_degree(jg))
    _same_csr(builder.relabel_by_degree(g, ascending=True),
              jbuilder.relabel_by_degree(jg, ascending=True))
    assert builder.worth_relabelling(g) == jbuilder.worth_relabelling(jg)
    _same_csr(builder.build_csr(el, symmetrize=False, dedup=False),
              jbuilder.build_csr(el, symmetrize=False, dedup=False))
    w = np.random.default_rng(0).integers(1, 9, len(el))
    gw, jgw = (builder.build_csr_weighted(el, w),
               jbuilder.build_csr_weighted(el, w))
    _same_csr(gw, jgw)
    assert np.array_equal(gw.weights, jgw.weights)


def test_readers_equal(tmp_path):
    el = generators.generate_rmat_el(7, 4, seed=2)
    path = tmp_path / "g.el"
    np.savetxt(path, el, fmt="%d")
    _same_csr(readers.read_graph(str(path)), jreaders.read_graph(str(path)))
    mtx = tmp_path / "g.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                   "4 4 3\n1 2\n2 3\n3 1\n")
    _same_csr(readers.read_mtx(str(mtx)), jreaders.read_mtx(str(mtx)))
    g = readers.read_graph(str(path))
    npz = tmp_path / "g.npz"
    readers.save_npz(g, str(npz))
    _same_csr(readers.load_npz(str(npz)), g)
    with pytest.raises(ValueError):
        readers.read_graph(str(tmp_path / "g.xyz"))


def test_validate_padded_catches_faults():
    g = generators.generate_graph("kronecker", 7, 8)
    pg = PaddedGraph.from_csr(g, device="cpu")
    nbr, deg, n = pg.nbr.numpy(), pg.deg.numpy(), pg.num_nodes
    checks.validate_padded(nbr, deg, n)
    v = int(np.argmax(deg))
    bad = nbr.copy()
    bad[v, :2] = bad[v, 1::-1]               # unsorted row
    with pytest.raises(AssertionError, match="sorted"):
        checks.validate_padded(bad, deg, n)
    bad = nbr.copy()
    bad[v, 0] = SENTINEL                     # hole before the tail
    with pytest.raises(AssertionError):
        checks.validate_padded(bad, deg, n)
    bad = nbr.copy()
    bad[n, 0] = 0                            # clobbered guard row
    with pytest.raises(AssertionError):
        checks.validate_padded(bad, deg, n)
    with pytest.raises(AssertionError, match="guard"):
        checks.validate_padded(nbr[:n], deg[:n], n)


def test_validate_sorted_rows_catches_faults():
    rows = np.full((3, 5), SENTINEL, dtype=np.int32)
    rows[0, :3] = [1, 4, 9]
    rows[1, :5] = [0, 2, 3, 7, 8]
    checks.validate_sorted_rows(rows)
    checks.validate_sorted_rows(torch.from_numpy(rows))
    bad = rows.copy()
    bad[0, :2] = [4, 1]                      # unsorted
    with pytest.raises(AssertionError, match="row 0 not strictly sorted"):
        checks.validate_sorted_rows(bad)
    bad = rows.copy()
    bad[1, 1] = 0                            # repeated member
    with pytest.raises(AssertionError, match="row 1 not strictly sorted"):
        checks.validate_sorted_rows(bad)
    bad = rows.copy()
    bad[2, 3] = 5                            # member after the SENTINEL tail
    with pytest.raises(AssertionError, match="row 2 has SENTINEL holes"):
        checks.validate_sorted_rows(bad)


def test_paranoid_flag(monkeypatch):
    monkeypatch.delenv("GMS_TPU_PARANOID", raising=False)
    assert not checks.paranoid()
    checks.enable(True)
    try:
        assert checks.paranoid()
        g = generators.generate_graph("uniform", 6, 4)
        PaddedGraph.from_csr(g, device="cpu")  # validates on build
    finally:
        checks.enable(False)
    assert not checks.paranoid()
