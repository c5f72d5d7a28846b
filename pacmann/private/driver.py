"""End-to-end private search driver — programmatic core of the main binary.

Re-architecture of /root/reference/private-search.go:71-329 (C13 in SURVEY.md):
load-or-generate data, load-or-build graph with on-disk caching, PIR
preprocessing, the query loop with proactive hint refresh, timing split
online vs maintenance, answer/recall/report output. The CLI wrapper lives in
pacmann.cli.private_search.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import numpy as np

from pacmann.graph.beam_host import BeamSearcher
from pacmann.graph.recall import compute_recall
from pacmann.io.loaders import (
    load_float32_matrix,
    load_int_matrix,
    save_int_matrix,
)
from pacmann.io.report import PrivateSearchReport
from pacmann.private.oracle import FAILURE_PROB_LOG2, PIRGraphOracle


def gen_random_matrix(n: int, dim: int, rng) -> np.ndarray:
    """Uniform [0,1) float32 (private-search.go:42-52)."""
    return rng.random((n, dim), dtype=np.float32)


def gen_random_graph(n: int, m: int, rng) -> np.ndarray:
    """Random m out-edges, no self loops (private-search.go:55-69)."""
    g = rng.integers(0, n, size=(n, m), dtype=np.int64)
    self_rows = g == np.arange(n)[:, None]
    g[self_rows] = (g[self_rows] + 1) % n
    return g


@dataclasses.dataclass
class PrivateSearchConfig:
    """Flag set of private-search.go:72-88."""

    n: int = 1000
    dim: int = 128
    m: int = 32
    k: int = 10
    q: int = 100
    input_file: str = ""       # "" => synthetic vectors
    graph_file: str = ""       # "" => synthetic/built graph (no caching)
    query_file: str = ""       # "" => synthetic queries
    output_file: str = ""
    gnd_file: str = ""
    report_file: str = ""
    max_step: int = 20
    parallel: int = 3
    benchmarking: bool = False  # skip PIR prep, random access pattern
    rtt_ms: float = 50.0
    non_private: bool = False
    failure_prob_log2: int = FAILURE_PROB_LOG2
    device: bool = False        # PIR server DB on the device
    engine: str = "fused"       # "simple" | "fused" | "device" | "device-fused"
    concurrent: int = 1         # queries advanced in lockstep per oracle batch
    build_graph: bool = True    # build a real graph when no graph file
    profile_dir: str = ""       # write a JAX profiler trace of the query loop
    seed: int = 0
    verbose: bool = False
    start_mode: str = "random"  # "random" (reference parity) | "centroid"


@dataclasses.dataclass
class PrivateSearchResult:
    answers: np.ndarray          # (q, k) int
    reach_steps: np.ndarray      # (q, k) int
    recall: float                # -1 when no ground truth
    avg_query_time_s: float
    maintenance_time_s: float
    prep_time_s: float
    success_rate: float
    report: PrivateSearchReport


def dataset_name(input_file: str, n: int, dim: int, m: int) -> str:
    """The reference's dataset/cache naming convention
    (private-search.go:96-101): basename minus extension + _{n}_{dim}_{m}."""
    data = os.path.splitext(os.path.basename(input_file))[0]
    return f"{data}_{n}_{dim}_{m}"


def _load_or_make_inputs(cfg: PrivateSearchConfig, rng):
    if cfg.input_file == "synthetic":
        # the reference's explicit synthetic mode (private-search.go:105-116)
        cfg = dataclasses.replace(cfg, input_file="")
    elif cfg.input_file and not cfg.graph_file:
        # build-if-missing graph cache under the reference's default name
        # {workingDir}/{data}_{n}_{dim}_{m}_graph.npy (private-search.go:
        # 130-137); the aux record lands next to it as in :148-153
        work = os.path.dirname(cfg.input_file)
        ds = dataset_name(cfg.input_file, cfg.n, cfg.dim, cfg.m)
        cfg = dataclasses.replace(
            cfg, graph_file=os.path.join(work, ds + "_graph.npy"))

    build_vecs = None  # compact (u8) build-time alias when the source is bvecs
    if cfg.input_file and cfg.input_file.endswith(".bvecs"):
        # read the byte file ONCE: the u8 form uploads 4x smaller for the
        # graph build and widens to f32 on device (bit-identical edges —
        # see build_graph); the f32 view everything else needs derives
        # from it without a second file pass
        from pacmann.io.loaders import load_bvecs

        build_vecs = load_bvecs(cfg.input_file, cfg.n, cfg.dim,
                                keep_bytes=True)
        vectors = build_vecs.astype(np.float32)
    elif cfg.input_file:
        vectors = load_float32_matrix(cfg.input_file, cfg.n, cfg.dim)
    else:
        vectors = gen_random_matrix(cfg.n, cfg.dim, rng)

    if cfg.graph_file and os.path.exists(cfg.graph_file):
        graph = load_int_matrix(cfg.graph_file, cfg.n, cfg.m)
    elif cfg.build_graph:
        # build-if-missing with on-disk caching + build-time aux record
        # (private-search.go:139-160, aux file :148-153)
        from pacmann.graph.build import build_graph

        tb = time.perf_counter()
        graph = build_graph(build_vecs if build_vecs is not None else vectors,
                            cfg.m, seed=cfg.seed, verbose=cfg.verbose)
        build_s = time.perf_counter() - tb
        if cfg.graph_file:
            save_int_matrix(cfg.graph_file, graph)
            base, _ = os.path.splitext(cfg.graph_file)
            # aux record next to the graph (private-search.go:148-153):
            # {dataset}_graph.npy -> {dataset}_graph_aux.txt
            ds = (dataset_name(cfg.input_file, cfg.n, cfg.dim, cfg.m)
                  if cfg.input_file else f"synthetic_{cfg.n}_{cfg.dim}_{cfg.m}")
            with open(base + "_aux.txt", "w") as f:
                f.write(f"Dataset: {ds}\n"
                        f"Graph generation time: {build_s:.6f} s\n"
                        f"n={cfg.n} dim={cfg.dim} m={cfg.m}\n")
    else:
        # EXPLICITLY requested no build: a random graph gives meaningless
        # recall — never fall back to this silently.
        print("WARNING: build_graph=False and no graph file — using a RANDOM "
              "graph; recall will be meaningless.")
        graph = gen_random_graph(cfg.n, cfg.m, rng)

    if cfg.query_file:
        queries = load_float32_matrix(cfg.query_file, cfg.q, cfg.dim)
    else:
        queries = gen_random_matrix(cfg.q, cfg.dim, rng)
    return vectors, np.asarray(graph, np.int64), queries


def run_private_search(cfg: PrivateSearchConfig,
                       vectors: np.ndarray | None = None,
                       graph: np.ndarray | None = None,
                       queries: np.ndarray | None = None,
                       gnd: np.ndarray | None = None) -> PrivateSearchResult:
    """Full e2e private search. Arrays may be passed directly (tests) or
    loaded/generated per cfg (CLI)."""
    rng = np.random.default_rng(cfg.seed)
    if vectors is None or queries is None:
        v2, g2, q2 = _load_or_make_inputs(cfg, rng)
        vectors = vectors if vectors is not None else v2
        graph = graph if graph is not None else g2
        queries = queries if queries is not None else q2
    assert graph is not None

    import contextlib

    profile_cm = (jax.profiler.trace(cfg.profile_dir)
                  if cfg.profile_dir else contextlib.nullcontext())

    fused_mode = cfg.engine == "device-fused" and not cfg.non_private
    oracle = PIRGraphOracle(
        vectors, graph,
        skip_prep=cfg.benchmarking,
        non_private=cfg.non_private,
        device=cfg.device,
        engine="device" if fused_mode else cfg.engine,
        rng=rng,
        failure_prob_log2=cfg.failure_prob_log2,
        start_mode=cfg.start_mode,
    )
    frontend = BeamSearcher(oracle, rng)

    t0 = time.perf_counter()
    frontend.preprocess()
    prep_time = time.perf_counter() - t0

    pir = oracle.pir
    sp = cfg.max_step * cfg.parallel
    window = max(pir.support_batch_num // sp, 1) if pir is not None else 1

    answers = np.full((cfg.q, cfg.k), -1, np.int64)
    steps = np.full((cfg.q, cfg.k), -1, np.int64)
    maintenance = 0.0
    group = max(cfg.concurrent, 1)

    if fused_mode:
        # the whole beam+PIR search runs as one device program per group;
        # hint refreshes inside fs.search are tallied in fs.maintenance_s
        # and split out of the per-query compute time, mirroring the
        # reference report's two lines (private-search-report.txt:16,19)
        from pacmann.private.fused_search import FusedPrivateSearch

        sids, svecs, snbrs = frontend.start
        fs = FusedPrivateSearch(oracle.pir, sids, svecs, snbrs,
                                dim=cfg.dim, m=cfg.m, n=cfg.n)
        # warm-up compile on the first group shape; then a fresh budget.
        # In benchmarking mode (dummy prep requested) refreshes must also
        # be dummy — a real hint-gen here would silently distort timings.
        fs.refresh_dummy = cfg.benchmarking
        first = min(group, cfg.q)
        fs.search(queries[:first], cfg.k, cfg.max_step, cfg.parallel,
                  seed=cfg.seed)
        fs._refresh()
        fs.maintenance_s = 0.0
        t0 = time.perf_counter()
        with profile_cm:
            for i in range(0, cfg.q, group):
                j = min(i + group, cfg.q)
                g = queries[i:j]
                if g.shape[0] < group:  # pad to the compiled shape
                    g = np.concatenate(
                        [g, np.zeros((group - g.shape[0], cfg.dim),
                                     np.float32)])
                out, out_steps = fs.search(g, cfg.k, cfg.max_step,
                                           cfg.parallel, seed=cfg.seed + 1 + i,
                                           return_steps=True)
                answers[i:j] = out[: j - i]
                steps[i:j] = out_steps[: j - i]
        maintenance = fs.maintenance_s
        search_time = time.perf_counter() - t0 - maintenance
        avg_time = search_time / max(cfg.q, 1)
        return _finalize(cfg, oracle, answers, steps, avg_time, maintenance,
                         prep_time, gnd, window)

    t0 = time.perf_counter()
    for i in range(0, cfg.q, group):
        if cfg.verbose and i % 100 == 0:
            print(f"Processing query {i}")
        j = min(i + group, cfg.q)
        if group > 1:
            answers[i:j], steps[i:j] = frontend.search_knn_concurrent(
                queries[i:j], cfg.k, cfg.max_step, cfg.parallel,
                cfg.benchmarking)
        else:
            answers[i], steps[i] = frontend.search_knn(
                queries[i], cfg.k, cfg.max_step, cfg.parallel,
                cfg.benchmarking)
        # proactive refresh (private-search.go:224-230)
        if (pir is not None and not cfg.non_private
                and pir.finished_batch_num + sp * (j - i) + 10
                >= pir.support_batch_num):
            tm = time.perf_counter()
            pir.preprocessing()
            maintenance += time.perf_counter() - tm
    search_time = time.perf_counter() - t0 - maintenance
    avg_time = search_time / max(cfg.q, 1)
    return _finalize(cfg, oracle, answers, steps, avg_time, maintenance,
                     prep_time, gnd, window)


def _finalize(cfg, oracle, answers, steps, avg_time, maintenance, prep_time,
              gnd, window):
    pir = oracle.pir
    if cfg.output_file:
        save_int_matrix(cfg.output_file, answers)

    recall = -1.0
    if gnd is None and cfg.gnd_file:
        gnd = load_int_matrix(cfg.gnd_file, cfg.q, cfg.k)
    if gnd is not None:
        recall = compute_recall(gnd, answers, cfg.k)

    entry_bytes = 4 * cfg.dim + 4 * cfg.m
    report = PrivateSearchReport(
        vector_num=cfg.n,
        db_size_bytes=float(cfg.n) * entry_bytes,
        top_k=cfg.k,
        rounds=cfg.max_step,
        parallel=cfg.parallel,
        rtt_ms=cfg.rtt_ms,
        window_size=window,
        storage_bytes=pir.local_storage_size() if pir is not None else 0.0,
        extra_storage_bytes=(
            pir.extra_storage_size()
            if pir is not None and hasattr(pir, "extra_storage_size") else 0.0),
        prep_time_s=prep_time,
        offline_comm_per_batch_bytes=(
            pir.comm_cost_per_batch_offline if pir is not None else 0.0),
        maintain_time_per_q_s=(
            prep_time / window if pir is not None else 0.0),
        avg_compute_time_per_q_s=avg_time,
        online_comm_per_batch_bytes=(
            pir.comm_cost_per_batch_online() if pir is not None else 0.0),
        recall=recall,
    )
    if cfg.report_file:
        report.append_to(cfg.report_file)

    return PrivateSearchResult(
        answers=answers,
        reach_steps=steps,
        recall=recall,
        avg_query_time_s=avg_time,
        maintenance_time_s=maintenance,
        prep_time_s=prep_time,
        success_rate=oracle.success_rate(),
        report=report,
    )
