"""Rules of the PyTorch port: it imports neither jax nor gms_tpu, its entry
points default to the card and raise without one, and its CLI and harness
keep gms_tpu's grammar and stdout protocol (plus --device)."""

import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from gms_tpu_torch.algorithms import bron_kerbosch as bk
from gms_tpu_torch.algorithms import coloring as gc
from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms import k_clique_star as ks
from gms_tpu_torch.algorithms import link_prediction as lp
from gms_tpu_torch.algorithms import similarity as vs
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.graphs.bitmap import BitmapGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.harness import benchmark, cli, printer, timers
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.preprocessing import degeneracy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_neither_jax_nor_gms_tpu():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import gms_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            gms_tpu_torch.__path__, "gms_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "gms_tpu" or m.startswith("gms_tpu."))
        print(len(names), bad)
    """)
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20  # every module of the port was imported
    assert bad == "[]"


def _triangle():
    return build_csr(np.array([[0, 1], [1, 2], [2, 0]]))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    g = _triangle()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.TrianglePlan(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.triangle_count(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PaddedGraph.from_csr(g)
    for k in (1, 3, 6):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kc.kclique_count(g, k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kc.plan_chunks(g, 3)
    for collect in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bk.bron_kerbosch(g, collect=collect)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bk.BKPlan(g, np.arange(3), np.arange(3))
    assert tc.triangle_count(g, device="cpu") == 1
    assert kc.kclique_count(g, 3, device="cpu") == 1
    assert bk.bron_kerbosch(g, device="cpu") == 1


def test_kclique_star_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    g = _triangle()
    for mode in ("list", "count"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ks.kclique_star_list(g, 3, mode=mode)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ks.plan_star_jobs(g, 3)
    assert ks.kclique_star_list(g, 3, device="cpu") == [
        (frozenset({0, 1, 2}), frozenset())]
    assert ks.kclique_star_list(g, 2, device="cpu", mode="count") == (3, 3)


def test_per_vertex_dense_and_adg_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    g = _triangle()
    for call in (lambda: tc.triangle_count_per_vertex(g),
                 lambda: tc.plan_per_vertex(g),
                 lambda: tc.triangle_count_dense(g),
                 lambda: BitmapGraph.from_csr(g),
                 lambda: degeneracy.triangle_count_ordering_rank(g),
                 lambda: degeneracy.adg_ordering_rank_device(g),
                 lambda: degeneracy.adg_ordering_rank_device(g, 0.1,
                                                             "prob_min")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tc.triangle_count_per_vertex(g, device="cpu").tolist() == [1, 1, 1]
    assert tc.triangle_count_dense(g, device="cpu") == 1
    assert degeneracy.adg_ordering_rank_device(g, device="cpu").tolist() == [
        0, 1, 2]
    assert degeneracy.triangle_count_ordering_rank(
        g, device="cpu").tolist() == [0, 1, 2]


def test_similarity_and_lp_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    g = build_csr(generate_rmat_el(6, 8, seed=1), num_nodes=64)
    train, test = lp.extract_random_test_edges(g, 20, seed=1)
    pairs = np.array([[0, 1], [2, 3]])
    for call in (lambda: vs.vertex_similarity(g, pairs, "jaccard"),
                 lambda: lp.AUCPlan(g, train, test, 50),
                 lambda: lp.score_auc(g, train, test, 50),
                 lambda: lp.link_prediction_similarity(train, 5),
                 lambda: lp._link_prediction_similarity_plain(train, 5),
                 lambda: lp._train_tables(train)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert vs.vertex_similarity(g, pairs, "common_neighbors",
                                device="cpu").dtype == np.float32
    assert 0 <= lp.AUCPlan(g, train, test, 50, device="cpu").run() <= 1
    assert 0 <= lp.score_auc(g, train, test, 50, device="cpu") <= 1
    edges, scores = lp.link_prediction_similarity(train, 5, device="cpu")
    assert edges.shape == (5, 2) and scores.shape == (5,)
    import gms_tpu_torch
    assert gms_tpu_torch.vertex_similarity is vs.vertex_similarity
    assert gms_tpu_torch.AUCPlan is lp.AUCPlan


def test_coloring_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    g = _triangle()
    calls = (lambda **kw: gc.jones_plassmann(g, **kw),
             lambda **kw: gc.jones_plassmann(g, speculative=True, **kw),
             lambda **kw: gc.johansson(g, **kw),
             lambda **kw: gc.barenboim_elkin(g, **kw),
             lambda **kw: gc.barenboim_elkin(g, variant="elkin", **kw),
             lambda **kw: gc.dense_sparse(g, **kw),
             lambda **kw: gc._TierGraph(g).to(**kw))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in calls[:-1]:
        assert sorted(call(device="cpu").tolist()) == [0, 1, 2]
    import gms_tpu_torch
    from gms_tpu_torch import algorithms
    assert gms_tpu_torch.jones_plassmann is gc.jones_plassmann
    assert algorithms.dense_sparse is gc.dense_sparse


def test_cli_parses_device():
    args = cli.Parser().parse(["-g", "kronecker", "8", "-n", "2"])
    assert (args.device, args.gen, args.scale, args.trials) == (
        "cuda", "kronecker", 8, 2)
    args = cli.Parser().add_param("k", 3).parse(
        ["-f", "x.el", "--device", "cpu", "-p", "k=5"])
    assert (args.device, args.file, args.params) == ("cpu", "x.el", {"k": 5})
    with pytest.raises(SystemExit):
        cli.Parser().parse(["-g", "kronecker", "8", "--device", "tpu"])
    with pytest.raises(SystemExit):
        cli.Parser().parse(["--device", "cpu"])


def test_bench_cli_prints_result_rows():
    out = _run(["-m", "gms_tpu_torch.bench.triangle_count", "-g", "kronecker",
                "8", "-n", "1", "-v", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    assert [r[-1] for r in rows] == ["tc-total-tiered-cpu", "tc-vertex-cpu"]
    assert all(r[2] == "verified" for r in rows)
    params = {ln.split()[1] for ln in out.stdout.splitlines()
              if ln.startswith("@@#")}
    assert params == {"tc_edges_per_sec", "tc_model_gbps"}
    assert "GraphExec buildTime:" in out.stdout


def test_preprocessing_bench_cli_prints_result_rows():
    out = _run(["-m", "gms_tpu_torch.bench.preprocessing", "-g", "kronecker",
                "8", "-n", "1", "-v", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    adg = [f"pp-adg-{b}-eps{e}" for b in ("avg", "min", "prob_min",
                                          "prob_median")
           for e in (0.01, 0.1, 0.5)]
    assert [r[-1] for r in rows] == ["pp-degree", "pp-degeneracy-exact", *adg]
    assert all(r[2] == "verified" for r in rows[2:])
    ratios = [float(ln.split()[2]) for ln in out.stdout.splitlines()
              if ln.startswith("@@# adg_ratio ")]
    assert len(ratios) == 12 and all(1 <= r <= 5 for r in ratios)


def test_bk_bench_cli_prints_result_rows():
    out = _run(["-m", "gms_tpu_torch.bench.bron_kerbosch", "-g", "kronecker",
                "8", "-n", "1", "-v", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    assert [r[-1] for r in rows] == ["BK-GMS-ADG-cpu", "BK-GMS-DEG-cpu",
                                     "BK-GMS-DGR-cpu", "BK-GMS-SG-cpu"]
    assert all(r[2] == "verified" for r in rows)
    counts = {ln.split()[2] for ln in out.stdout.splitlines()
              if ln.startswith("@@# bk_cliques ")}
    assert counts == {"1915"}  # RMAT-8 deg 16, seed 27491095
    params = {ln.split()[1] for ln in out.stdout.splitlines()
              if ln.startswith("@@#")}
    assert params == {"bk_cliques", "bk_cliques_per_sec"}


def test_kcstar_bench_cli_prints_result_rows():
    out = _run(["-m", "gms_tpu_torch.bench.k_clique_star", "-g", "kronecker",
                "6", "-n", "1", "-v", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    assert [r[-1] for r in rows] == ["kcstar-k3-count-cpu"]
    assert rows[0][2] == "verified"
    params = {ln.split()[1]: ln.split()[2] for ln in out.stdout.splitlines()
              if ln.startswith("@@#")}
    assert set(params) == {"kcs_cliques", "kcs_star_total",
                           "kcstar_cliques_per_sec", "kcstar_star_total"}
    # RMAT-6 deg 16, seed 27491095: the star total is 4 x its 4-cliques
    assert params["kcs_star_total"] == params["kcstar_star_total"]
    g = build_csr(generate_rmat_el(6, 16, seed=27491095), num_nodes=64)
    assert int(params["kcs_cliques"]) == kc.kclique_count(g, 3, device="cpu")
    assert int(params["kcstar_star_total"]) == \
        4 * kc.kclique_count(g, 4, device="cpu")


def test_lp_bench_cli_prints_result_rows():
    out = _run(["-m", "gms_tpu_torch.bench.link_prediction", "-g",
                "kronecker", "8", "-n", "1", "-v", "--device", "cpu", "-p",
                "samples=500", "-p", "q-best=20"])
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    metrics = ("jaccard", "overlap", "adamic_adar", "resource",
               "common_neighbors")
    assert [r[-2:] for r in rows] == [
        *([f"lp-auc-{m}", "500"] for m in metrics), ["lp-rank-jaccard", "20"]]
    assert all(r[2] == "verified" for r in rows[:5])
    aucs = {ln.split()[1]: float(ln.split()[2]) for ln in out.stdout.splitlines()
            if ln.startswith("@@# auc_")}
    assert set(aucs) == {f"auc_{m}" for m in metrics}
    assert all(0.5 < a <= 1 for a in aucs.values())


def test_coloring_bench_cli_prints_result_rows():
    out = _run(["-m", "gms_tpu_torch.bench.coloring", "-g", "kronecker", "8",
                "-n", "1", "-v", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    names = ("jp-spec", "jp-spec-lf", "jp-random", "jp-lf", "johansson",
             "greedy-seq")
    assert [r[-1] for r in rows] == [f"coloring-{n}" for n in names]
    assert all(r[2] == "verified" for r in rows)
    counts = {ln.split()[1]: int(ln.split()[2]) for ln in out.stdout.splitlines()
              if ln.startswith("@@# colors_")}
    assert set(counts) == {f"colors_{n}" for n in names}
    g = build_csr(generate_rmat_el(8, 16, seed=27491095), num_nodes=256)
    assert counts["colors_jp-lf"] == gc.unique_colors_count(
        gc.jones_plassmann(g, priority="degree", device="cpu"))


def test_printer_protocol():
    buf = io.StringIO()
    printer.Printer(out=buf).enqueue(1.5, "x", 3).print()
    printer.print_param("n", 0.25, out=buf)
    printer.print_info("note", out=buf)
    assert buf.getvalue().splitlines() == [
        "@@@ 1.50000 x 3", "@@# n 0.25000", "@## note"]


def test_benchmark_runners(capsys):
    args = cli.Args(trials=2, verify=True, gen="kronecker", scale=4)
    g = _triangle()
    r = benchmark.benchmark_kernel(
        args, g, lambda g: tc.triangle_count(g, device="cpu"),
        verifier=lambda g, r: r == 1, labels=("tc",))
    assert r == 1
    r = benchmark.benchmark_kernel_bk_pp(
        args, g, build=lambda g: tc.TrianglePlan(g, device="cpu"),
        preprocess=lambda g: torch.arange(3), kernel=lambda p, o: p.run(),
        verifier=lambda g, r: r == 1, labels=("pp",))
    assert r == 1
    r = benchmark.Pipeline(args, labels=("pipe",)).run(
        ("one", lambda c: torch.ones(2)), ("two", lambda c: c.sum()))
    assert int(r) == 2
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("@@@")]
    assert len(rows) == 6 and out.count("Average Time:") == 2


def test_timers(tmp_path):
    t = timers.Timer()
    t.start()
    assert t.stop(sync_on=[torch.zeros(2), torch.device("cpu")]) >= 0
    d = timers.DetailTimer()
    d.phase("a", sync_on=torch.zeros(1))
    buf = io.StringIO()
    d.print(out=buf)
    assert buf.getvalue().startswith("a:")
    with timers.ProfileScope(None):
        pass
    with timers.ProfileScope(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
