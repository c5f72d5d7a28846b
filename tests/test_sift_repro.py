"""One-command real-SIFT reproduction path, exercised end to end on the
checked-in binary fixtures (tests/fixtures/): the exact file formats,
loader spot-value semantics, graph cache naming, and report schema the
reference uses on real SIFT1M — so pointing run-private-search.sh at real
bigann files is the ONLY remaining step (dataset egress is blocked here).

Reference anchors: graphann/loader_test.go:9-35 (bvecs spot values),
private-search.go:96-153 ({data}_{n}_{dim}_{m} cache naming + aux record),
run-private-search.sh (INPUT/QUERY/GND env wiring).
"""

import os
import shutil

import numpy as np
import pytest

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
N, DIM, M, Q, K = 256, 128, 8, 8, 10


def test_bvecs_spot_values_reference_semantics():
    """The reference's loader test asserts exact spot values on bigann
    bvecs (loader_test.go:29-35); the fixtures reproduce those values and
    the loader must surface them identically as float32."""
    from pacmann.io.loaders import LoadFloat32Matrix, load_bvecs

    v = LoadFloat32Matrix(os.path.join(FIX, "mini_base.bvecs"), 10, DIM)
    assert v.shape == (10, DIM) and v.dtype == np.float32
    assert v[0][3] == 1.0
    assert v[1][0] == 65.0
    # compact u8 form used by the graph build: same values, 4x smaller
    b = load_bvecs(os.path.join(FIX, "mini_base.bvecs"), 10, DIM,
                   keep_bytes=True)
    assert b.dtype == np.uint8 and np.array_equal(b.astype(np.float32), v)


def test_fvecs_ivecs_fixture_roundtrip():
    from pacmann.io.loaders import load_fvecs, load_ivecs

    q = load_fvecs(os.path.join(FIX, "mini_query.fvecs"), Q, DIM)
    g = load_ivecs(os.path.join(FIX, "mini_gnd.ivecs"), Q, K)
    assert q.shape == (Q, DIM) and q.dtype == np.float32
    assert g.shape == (Q, K) and g.dtype == np.int32
    assert (g >= 0).all() and (g < N).all()


@pytest.mark.parametrize("engine", ["device-fused"])
def test_one_command_repro_path(tmp_path, engine):
    """The full reference pipeline from FILES: bvecs base + fvecs queries +
    ivecs ground truth -> build-or-load graph under the reference's
    {data}_{n}_{dim}_{m}_graph.npy cache name (+ aux record) -> private
    search -> recall + appended report. Second run must LOAD the cached
    graph (not rebuild) and reproduce the same answers."""
    from pacmann.cli.private_search import main

    for f in ("mini_base.bvecs", "mini_query.fvecs", "mini_gnd.ivecs"):
        shutil.copy(os.path.join(FIX, f), tmp_path / f)
    report = tmp_path / "report.txt"
    out1 = tmp_path / "answers1.txt"
    out2 = tmp_path / "answers2.txt"

    def run(out):
        argv = ["-n", str(N), "-d", str(DIM), "-m", str(M), "-k", str(K),
                "-q", str(Q), "-step", "8", "-parallel", "3",
                "-engine", engine, "-concurrent", "2",
                "-input", str(tmp_path / "mini_base.bvecs"),
                "-query", str(tmp_path / "mini_query.fvecs"),
                "-gnd", str(tmp_path / "mini_gnd.ivecs"),
                "-output", str(out), "-report", str(report),
                "-seed", "3"]
        assert main(argv) == 0

    run(out1)
    graph_f = tmp_path / f"mini_base_{N}_{DIM}_{M}_graph.npy"
    aux_f = tmp_path / f"mini_base_{N}_{DIM}_{M}_graph_aux.txt"
    assert graph_f.exists(), "graph cache missing under the reference name"
    aux = aux_f.read_text()
    assert aux.startswith(f"Dataset: mini_base_{N}_{DIM}_{M}\n")
    assert "Graph generation time:" in aux
    graph_mtime = graph_f.stat().st_mtime_ns

    # cached second run: same graph file (untouched), same answers
    run(out2)
    assert graph_f.stat().st_mtime_ns == graph_mtime, "graph was rebuilt"

    from pacmann.graph.recall import compute_recall
    from pacmann.io.loaders import load_int_matrix

    gnd = load_int_matrix(str(tmp_path / "mini_gnd.ivecs"), Q, K)
    a1 = load_int_matrix(str(out1), Q, K)
    a2 = load_int_matrix(str(out2), Q, K)
    assert np.array_equal(a1, a2), "cached-graph run diverged"
    rec = compute_recall(gnd, a1, K)
    # 256 random-byte vectors, 8 queries: the beam visits most of the DB
    # (8 steps x 3 x 8 fetches); private recall stays high
    assert rec >= 0.7, rec

    # report schema: appended once per run, reference field lines present
    rep = report.read_text()
    assert rep.count("Vector Num:") == 2
    for line in ("Top K:", "Rounds:", "Recall:", "Preprocessing Cost:"):
        assert line in rep, line
