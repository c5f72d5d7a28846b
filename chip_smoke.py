"""Smoke run of the private search service on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
reference's SIFT1M-shaped deployment (1e6 entries of 640 B = 128 f32 ‖ 32
u32 neighbour ids, batch 32 -> 16 PIR partitions, FailureProbLog2 8), with
data made on the device from --seed, and checks every result against the
repo's plain host twins:

  1. device   one `gpu` device; card name and power limit; XLA_FLAGS
  2. pir      DevicePianoEngine: prep twice (warm, timed); all PRF tables vs
              the host AES oracle; 256 parity rows vs xor_scan_np; every
              replacement value vs its raw row; 10 batches of 96 through
              query(): every served entry equals its raw row, success >= 0.98
  3. fused    FusedPrivateSearch at groups 1 and 16 (max_step 20, parallel 3,
              k 10): fetch success within 0.02 of the analytic bound; the
              one-program and split routes agree (PIR state bit for bit)
  4. graph    continuum latent-16 data, n=100k, d=128, m=32: build_graph,
              1,000 queries; device beam recall@10 within 0.02 of the host
              beam twin, >= 0.9 against brute force; private recall via
              run_private_search(engine="device-fused") within 0.02 of it
  --four      (only this phase) ShardedPianoEngine over 4 cards and
              ChunkShardedPianoEngine at P=2, each against a single-card
              DevicePianoEngine in the same process: PIR state and entries
              bit for bit; fused search at group 16 (partition-sharded)

Usage: python chip_smoke.py [--seed 0] [--four]
Any failed check raises (non-zero exit, no result line). The last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import pacmann  # noqa: F401  (fails outside a checkout: no result line)

DIM, M, K, STEP, PAR = 128, 32, 10, 20, 3
ENTRY_BYTES = 4 * (DIM + M)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields):
    print(f"phase {phase}: " + json.dumps(fields, default=float), flush=True)


# ---------------------------------------------------------------------------
# 1. device


def phase_device(count: int):
    import jax

    from pacmann.utils.platform import backend, card_name_power

    devs = jax.devices()
    if backend() != "gpu" or len(devs) < count:
        print(f"chip_smoke: needs {count} GPU device(s); JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        sys.exit(2)
    card = card_name_power()
    print(f"card: {card}", flush=True)
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), card=card, xla_flags=os.environ.get("XLA_FLAGS", ""))
    return devs


# ---------------------------------------------------------------------------
# 2. PIR at the SIFT1M shape


def _prep_inputs(eng, seed: int):
    """Replay preprocessing()'s RNG draws: (repl_off, keys)."""
    p, P = eng.params, eng.config.partition_num
    rng = np.random.default_rng(seed)
    repl_off = (rng.integers(0, 2**32, size=(P, p.set_size,
                                             p.max_query_per_chunk),
                             dtype=np.uint64)
                & np.uint64(p.chunk_mask)).astype(np.uint32)
    return repl_off, [rng.bytes(16) for _ in range(P)]


def _rows(raw, ids):
    return np.asarray(raw[np.asarray(ids, np.int64)])


def check_prep(eng, raw, seed: int, n_parity: int = 256):
    """Offline state vs the host twins: every PRF table against the host
    AES oracle, sampled parity rows against xor_scan_np, every replacement
    value against its raw row."""
    from pacmann.ops import aes
    from pacmann.ops.xor_scan import xor_scan_np

    p, c = eng.params, eng.config
    P, S, C, R, Hp = (c.partition_num, p.set_size, p.chunk_size,
                      p.max_query_per_chunk, p.primary_hint_num)
    T = Hp + S * R
    E = c.entry_bytes // 4
    repl_off, keys = _prep_inputs(eng, seed)
    tables = np.stack([aes.prf_offset_table_host(kb, T, S, p.chunk_mask)
                       for kb in keys])
    check(np.array_equal(np.asarray(eng.state["table"]).astype(np.uint32),
                         tables), "PRF tables differ from the host AES oracle")

    rng = np.random.default_rng(seed + 7)
    rows = rng.integers(0, P * T, size=n_parity)
    parity = np.concatenate([np.asarray(eng.state["primary_parity"]),
                             np.asarray(eng.state["backup_parity"])], axis=1)
    for part in np.unique(rows // T):
        db_p = np.asarray(eng.db[:, part])
        ts = rows[rows // T == part] % T
        skip = (ts[:, None] >= Hp) & (
            np.arange(S)[None, :] == (ts[:, None] - Hp) // R)
        want = xor_scan_np(db_p, tables[part, ts], skip, eng.k)
        check(np.array_equal(parity[part, ts], want.reshape(len(ts), -1)),
              f"parity rows of partition {part} differ from xor_scan_np")

    local = (np.arange(S)[None, :, None] * C + repl_off).astype(np.int64)
    gidx = np.arange(P)[:, None, None] * c.partition_size + local
    real = (local < c.partition_size) & (gidx < c.db_size)
    want = np.zeros(repl_off.shape + (E,), np.uint32)
    want[real] = _rows(raw, gidx[real])
    got = np.asarray(eng.state["repl_val"])[..., :E]
    check(np.array_equal(got, want), "replacement values differ from raw")
    return dict(tables=int(P), table_evals=int(P * T * S),
                parity_rows=int(n_parity), repl_rows=int(real.sum()))


def serve_batches(eng, raw, n: int, seed: int, batches: int = 10,
                  size: int = 96):
    """`batches` timed query() batches of `size` spread ids (one warm-up
    batch first). Every served entry must equal its raw row; an unserved
    one is all zeros. Returns (ms per batch, success rate)."""
    rng = np.random.default_rng(seed)
    eng.query([int(i) for i in rng.integers(0, n, size)])
    outs = []
    t0 = time.perf_counter()
    for _ in range(batches):
        ids = [int(i) for i in rng.integers(0, n, size)]
        outs.append((ids, eng.query(ids)))
    ms = (time.perf_counter() - t0) / batches * 1e3
    ok = tot = 0
    for ids, out in outs:
        want = _rows(raw, ids)
        match = np.all(out == want, axis=1)
        check(np.all(match | np.all(out == 0, axis=1)),
              "a served entry differs from its raw row")
        ok += int(match.sum())
        tot += len(ids)
    return ms, ok / tot


def phase_pir(n: int, seed: int, batches: int = 10):
    import jax

    from pacmann.io.synth import synth_raw_device
    from pacmann.pir.device_engine import DevicePianoEngine

    t0 = time.perf_counter()
    raw = synth_raw_device(n, DIM + M, seed, float_cols=DIM, nbr_cols=M)
    eng = DevicePianoEngine(n, ENTRY_BYTES, M, raw, 8)
    jax.block_until_ready(eng.db)
    setup_s = time.perf_counter() - t0
    eng.preprocessing(rng=np.random.default_rng(seed + 1))
    cold_s = eng.preprocessing_time
    eng.preprocessing(rng=np.random.default_rng(seed + 2))
    warm_s = eng.preprocessing_time
    checked = check_prep(eng, raw, seed + 2)
    batch_ms, success = serve_batches(eng, raw, n, seed + 3, batches)
    check(success >= 0.98, f"batch-96 success {success:.4f} < 0.98")
    emit("pir", n=n, setup_s=setup_s, prep_cold_s=cold_s, prep_s=warm_s,
         batch96_ms=batch_ms, batch96_success=success, **checked)
    return eng, raw


# ---------------------------------------------------------------------------
# 3. fused private search


def _fused(eng, raw, n: int, seed: int):
    from pacmann.private.fused_search import FusedPrivateSearch

    rng = np.random.default_rng(seed)
    sids = rng.choice(n, min(1000, int(np.sqrt(n))), replace=False)
    srows = _rows(raw, sids)
    svecs = np.ascontiguousarray(srows[:, :DIM]).view("<f4")
    snbrs = srows[:, DIM:DIM + M].astype(np.int64) % n
    return FusedPrivateSearch(eng, sids, svecs, snbrs, dim=DIM, m=M, n=n)


def _route_pair(eng, fs, q, seed: int):
    """The same search on the one-program and the split route, each from
    the same fresh hint window: (answers, PIR state) per route."""
    import jax

    out = {}
    for split in (False, True):
        eng.preprocessing(rng=np.random.default_rng(seed))
        eng._rng = np.random.default_rng(seed + 1)
        fs.split_route = split
        ids = fs.search(q, k=K, max_step=STEP, parallel=PAR, seed=seed)
        out[split] = (ids, jax.device_get(
            {k: eng.state[k] for k in ("tag", "prog", "primary_parity",
                                        "slot_col", "hist", "finished")}))
    fs.split_route = None
    return out[False], out[True]


def answers_agree(a, b, tol: float = 0.005) -> float:
    """Share of answer ids two runs have in common, per query row."""
    same = [len(set(x.tolist()) & set(y.tolist())) / max(len(x), 1)
            for x, y in zip(a, b)]
    return float(np.mean(same))


def phase_fused(eng, raw, n: int, seed: int, groups=(1, 16), reps: int = 3):
    from pacmann.pir.params import expected_success_rate

    P = eng.config.partition_num
    fs = _fused(eng, raw, n, seed)
    rng = np.random.default_rng(seed + 1)
    res = {}
    for G in groups:
        q = rng.random((G, DIM), dtype=np.float32)
        fs.search(q, k=K, max_step=STEP, parallel=PAR, seed=seed)  # compile
        fs.fetch_stats[:] = 0
        fs.maintenance_s = 0.0
        comp = []
        for r in range(reps):
            fs.ensure_budget(STEP, G, PAR)
            t0 = time.perf_counter()
            fs.search(q, k=K, max_step=STEP, parallel=PAR, seed=seed + 1 + r)
            comp.append(time.perf_counter() - t0 - fs.last_maintenance_s)
        quota = G * PAR * M // P
        want = int(round(fs.fetch_stats[0] / (reps * STEP)))
        bound = expected_success_rate(want, P, quota, 8)
        succ = fs.fetch_success_rate()
        check(abs(succ - bound) <= 0.02,
              f"group {G}: fetch success {succ:.4f} vs bound {bound:.4f}")
        (ids_a, st_a), (ids_b, st_b) = _route_pair(eng, fs, q, seed + 50 + G)
        for key in st_a:
            check(np.array_equal(st_a[key], st_b[key]),
                  f"group {G}: split route PIR state {key} differs")
        agree = answers_agree(ids_a, ids_b)
        check(agree >= 0.995, f"group {G}: routes agree on {agree:.4f} of "
                              "the answers")
        res[G] = dict(ms_per_query=min(comp) * 1e3 / G,
                      maintenance_ms_per_query=fs.maintenance_s * 1e3
                      / (reps * G), fetch_success=succ, bound=bound,
                      routes_identical=bool(np.array_equal(ids_a, ids_b)),
                      routes_agree=agree)
    emit("fused", **{f"g{g}": v for g, v in res.items()})
    return res


# ---------------------------------------------------------------------------
# 4. graph build and recall


def phase_graph(n: int, seed: int, n_queries: int = 1000, rounds: int = 8,
                concurrent: int = 16, min_recall: float = 0.9):
    from pacmann.graph.beam import PlaintextEngine
    from pacmann.graph.beam_host import BasicGraphOracle, BeamSearcher
    from pacmann.graph.build import build_graph
    from pacmann.graph.recall import brute_force_knn, compute_recall
    from pacmann.io.synth import synth_continuum
    from pacmann.private.driver import PrivateSearchConfig, run_private_search

    rng = np.random.default_rng(seed)
    vectors = synth_continuum(n, DIM, rng, latent=16)
    t0 = time.perf_counter()
    graph = np.asarray(build_graph(vectors, M, rounds=rounds, seed=seed),
                       np.int64)
    build_s = time.perf_counter() - t0
    queries = (vectors[rng.choice(n, n_queries, replace=False)]
               + 0.1 * rng.standard_normal((n_queries, DIM))
               .astype(np.float32))
    gnd = brute_force_knn(vectors, queries, K)

    t0 = time.perf_counter()
    ids_dev, _ = PlaintextEngine(vectors, graph).search(
        queries, K, STEP, PAR, seed=seed)
    dev_s = time.perf_counter() - t0
    host = BeamSearcher(BasicGraphOracle(vectors, graph),
                        np.random.default_rng(seed))
    host.preprocess()
    ids_host, _ = host.search_knn_batch(queries, K, STEP, PAR)
    r_dev = compute_recall(gnd, ids_dev, K)
    r_host = compute_recall(gnd, ids_host, K)
    check(abs(r_dev - r_host) <= 0.02,
          f"device beam recall {r_dev:.4f} vs host twin {r_host:.4f}")
    check(r_dev >= min_recall, f"recall@10 {r_dev:.4f} < {min_recall}")

    cfg = PrivateSearchConfig(n=n, dim=DIM, m=M, k=K, q=n_queries,
                              max_step=STEP, parallel=PAR, build_graph=False,
                              engine="device-fused", concurrent=concurrent,
                              seed=seed)
    t0 = time.perf_counter()
    priv = run_private_search(cfg, vectors=vectors, graph=graph,
                              queries=queries, gnd=gnd)
    priv_s = time.perf_counter() - t0
    check(abs(priv.recall - r_dev) <= 0.02,
          f"private recall {priv.recall:.4f} vs plaintext {r_dev:.4f}")
    emit("graph", n=n, build_s=build_s, recall_device=r_dev,
         recall_host=r_host, recall_private=priv.recall,
         plaintext_search_s=dev_s, private_run_s=priv_s,
         private_ms_per_query=priv.avg_query_time_s * 1e3,
         private_maintenance_s=priv.maintenance_time_s)
    return dict(recall_device=r_dev, recall_host=r_host,
                recall_private=priv.recall)


# ---------------------------------------------------------------------------
# --four: sharded engines across four cards


_STATE_KEYS = ("table", "slot_col", "tag", "prog", "primary_parity",
               "backup_parity", "repl_idx", "repl_val", "hist", "finished")


def _same_state(a, b, what: str):
    for key in _STATE_KEYS:
        check(np.array_equal(np.asarray(a.state[key]),
                             np.asarray(b.state[key])),
              f"{what}: state {key} differs from the single-card engine")


def _compare_engines(single, multi, raw, n: int, seed: int, what: str,
                     batches: int = 10, group: int | None = 16):
    """Same seeds on both engines: offline state, `batches` batches of 96
    (entries and state), then — unless group is None — the fused search at
    `group` queries (state and answers)."""
    import jax

    single.preprocessing(rng=np.random.default_rng(seed))
    multi.preprocessing(rng=np.random.default_rng(seed))
    _same_state(single, multi, what + " prep")
    rng = np.random.default_rng(seed + 1)
    t = {}
    for eng, name in ((single, "single"), (multi, "multi")):
        eng._rng = np.random.default_rng(seed + 2)
    outs = {"single": [], "multi": []}
    for _ in range(batches + 1):
        ids = [int(i) for i in rng.integers(0, n, 96)]
        for eng, name in ((single, "single"), (multi, "multi")):
            t0 = time.perf_counter()
            outs[name].append((ids, eng.query(ids)))
            t.setdefault(name, []).append(time.perf_counter() - t0)
    ok = tot = 0
    for (ids, a), (_, b) in zip(outs["single"], outs["multi"]):
        check(np.array_equal(a, b), f"{what}: served entries differ")
        match = np.all(a == _rows(raw, ids), axis=1)
        check(np.all(match | np.all(a == 0, axis=1)),
              f"{what}: a served entry differs from its raw row")
        ok, tot = ok + int(match.sum()), tot + len(ids)
    _same_state(single, multi, what + " online")
    res = dict(batch96_ms_single=np.median(t["single"][1:]) * 1e3,
               batch96_ms_multi=np.median(t["multi"][1:]) * 1e3,
               success=ok / tot)
    if group is None:
        return res
    fs = {name: _fused(eng, raw, n, seed + 3)
          for eng, name in ((single, "single"), (multi, "multi"))}
    q = np.random.default_rng(seed + 4).random((group, DIM),
                                               dtype=np.float32)
    ans = {}
    for name, f in fs.items():
        f.engine.preprocessing(rng=np.random.default_rng(seed + 5))
        f.engine._rng = np.random.default_rng(seed + 6)
        f.search(q, k=K, max_step=STEP, parallel=PAR, seed=seed + 7)
        t0 = time.perf_counter()
        ans[name] = f.search(q, k=K, max_step=STEP, parallel=PAR,
                             seed=seed + 8)
        jax.block_until_ready(f.engine.state)
        t[name + "_fused_s"] = time.perf_counter() - t0
    for key in ("tag", "prog", "primary_parity", "hist", "finished"):
        check(np.array_equal(np.asarray(fs["single"].engine.state[key]),
                             np.asarray(fs["multi"].engine.state[key])),
              f"{what}: fused-search state {key} differs")
    agree = answers_agree(ans["single"], ans["multi"])
    check(agree >= 0.995, f"{what}: fused answers agree on {agree:.4f}")
    return dict(res, fused_answers_identical=bool(
                    np.array_equal(ans["single"], ans["multi"])),
                fused_agree=agree,
                fused_group=group, fused_s_single=t["single_fused_s"],
                fused_s_multi=t["multi_fused_s"])


def phase_four(n: int, seed: int, n_chunk: int | None = None, devices=4,
               batches: int = 10, group: int = 16):
    import jax

    from pacmann.io.synth import synth_raw_device
    from pacmann.parallel.sharding import make_mesh
    from pacmann.pir.device_engine import DevicePianoEngine
    from pacmann.pir.sharded_engine import (
        ChunkShardedPianoEngine, ShardedPianoEngine)

    mesh = make_mesh(devices)
    raw = synth_raw_device(n, DIM + M, seed, float_cols=DIM, nbr_cols=M)
    single = DevicePianoEngine(n, ENTRY_BYTES, M, raw, 8)
    multi = ShardedPianoEngine(n, ENTRY_BYTES, M, raw, 8, mesh)
    shards = multi.db.addressable_shards
    P = multi.config.partition_num
    check(len({s.device for s in shards}) == devices
          and all(s.data.shape[1] == P // devices for s in shards),
          "partition-sharded DB does not span the mesh one shard per card")
    multi.preprocessing(rng=np.random.default_rng(seed))
    for key in ("table", "primary_parity", "backup_parity", "repl_val"):
        sh = multi.state[key].addressable_shards
        check(len({s.device for s in sh}) == devices
              and all(s.data.shape[0] == P // devices for s in sh),
              f"partition-sharded state {key} is not one shard per card")
    part = _compare_engines(single, multi, raw, n, seed, "partition-sharded",
                            batches, group)
    emit("four_partition", devices=devices, P=P, **part)
    del single, multi

    n_chunk = n_chunk or n
    raw_c = raw if n_chunk == n else synth_raw_device(
        n_chunk, DIM + M, seed + 1, float_cols=DIM, nbr_cols=M)
    single = DevicePianoEngine(n_chunk, ENTRY_BYTES, 4, raw_c, 8)
    chunk = ChunkShardedPianoEngine(n_chunk, ENTRY_BYTES, 4, raw_c, 8, mesh)
    S = chunk.params.set_size
    shards = chunk.db.addressable_shards
    check(len({s.device for s in shards}) == devices
          and all(s.data.shape[0] == S // devices for s in shards),
          "chunk-sharded DB does not span the mesh one shard per card")
    # no fused search here: FusedPrivateSearch refuses a chunk-sharded
    # engine (its server scan would need an XOR all-reduce; ROADMAP)
    res = _compare_engines(single, chunk, raw_c, n_chunk, seed + 10,
                           "chunk-sharded", batches, None)
    emit("four_chunk", devices=devices, P=chunk.config.partition_num, S=S,
         **res)
    jax.block_until_ready(chunk.state)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--graph-n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded-engine phase")
    args = ap.parse_args(argv)

    from pacmann.utils.platform import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    devs = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(args.n, args.seed)
    else:
        eng, raw = phase_pir(args.n, args.seed)
        phase_fused(eng, raw, args.n, args.seed)
        del eng, raw
        phase_graph(args.graph_n, args.seed, args.queries)
    print(f"total_s: {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
