"""Host-tier beam search over an abstract vertex oracle.

Faithful functional twin of GraphANNFrontend.SearchKNN
(/root/reference/graphann/search.go:114-245): min-heap frontier keyed by L2
distance, `parallel` pops per round, batched neighbor fetch through the
oracle, dedup via a known-vertices map, random-id padding when the frontier
is empty (fixed access pattern), all-zero-neighbor skip, final answer = k
closest visited. Used for reference-parity tests and as the driver for the
host-orchestrated private path; the vectorized device engine lives in beam.py.
"""

from __future__ import annotations

import heapq

import numpy as np


class VertexOracle:
    """GetGraphInfo equivalent (search.go:20-25)."""

    def preprocess(self):  # pragma: no cover - interface
        raise NotImplementedError

    def get_metadata(self) -> tuple[int, int, int]:
        raise NotImplementedError

    def get_vertex_info(self, ids):
        """ids -> (vectors (B, dim) f32, neighbors (B, m) i64)"""
        raise NotImplementedError

    def get_start_vertices(self):
        """-> (ids (s,), vectors (s, dim), neighbors (s, m))"""
        raise NotImplementedError


class BasicGraphOracle(VertexOracle):
    """Plaintext in-memory oracle (BasicGraphInfo, search.go:29-65)."""

    def __init__(self, vectors: np.ndarray, graph: np.ndarray):
        self.vectors = np.asarray(vectors, np.float32)
        self.graph = np.asarray(graph, np.int64)

    def preprocess(self):
        pass

    def get_metadata(self):
        n, dim = self.vectors.shape
        return n, dim, self.graph.shape[1]

    def get_vertex_info(self, ids):
        ids = np.asarray(ids, np.int64)
        return self.vectors[ids], self.graph[ids]

    def get_start_vertices(self):
        n = self.vectors.shape[0]
        s = int(np.sqrt(n))
        ids = np.arange(s)  # first sqrt(n) ids (search.go:51-65)
        return ids, self.vectors[ids], self.graph[ids]


def _l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a.astype(np.float32) - b.astype(np.float32)
    return np.sum(d * d, axis=-1)


class BeamSearcher:
    """Frontend holding an oracle + start vertices (search.go:69-81)."""

    def __init__(self, oracle: VertexOracle, rng: np.random.Generator | None = None):
        self.oracle = oracle
        self.rng = rng or np.random.default_rng()
        self.start = None

    def preprocess(self):
        self.oracle.preprocess()
        self.start = self.oracle.get_start_vertices()

    def search_knn(self, query: np.ndarray, k: int, max_step: int,
                   parallel: int, benchmarking: bool = False):
        """-> (ids (k,), reach_steps (k,)); -1 padding (search.go:222-233)."""
        n, dim, m = self.oracle.get_metadata()
        query = np.asarray(query, np.float32)

        known: dict[int, tuple[np.ndarray, np.ndarray]] = {}  # id -> (vec, nbrs)
        dist: dict[int, float] = {}
        reach: dict[int, int] = {}
        frontier: list[tuple[float, int]] = []

        if not benchmarking:
            sids, svecs, snbrs = self.start
            sdist = _l2(svecs, query[None, :])
            order = np.argsort(sdist, kind="stable")
            count = 0
            for j in order:
                if count >= parallel:
                    break
                vid = int(sids[j])
                if vid in known:
                    continue
                known[vid] = (svecs[j], snbrs[j])
                dist[vid] = float(sdist[j])
                reach[vid] = 0
                heapq.heappush(frontier, (float(sdist[j]), vid))
                count += 1

        for step in range(max_step):
            batch: list[int] = []
            for _ in range(parallel):
                if not frontier or benchmarking:
                    batch.extend(
                        int(x) for x in self.rng.integers(0, n, size=m)
                    )
                else:
                    _, v = heapq.heappop(frontier)
                    batch.extend(int(x) for x in known[v][1])

            vecs, nbrs = self.oracle.get_vertex_info(batch)
            if benchmarking:
                continue

            cdist = _l2(vecs, query[None, :])
            for i, vid in enumerate(batch):
                if vid in known:
                    continue
                if not np.any(nbrs[i] != 0):  # all-zero = failed PIR fetch
                    continue
                known[vid] = (vecs[i], nbrs[i])
                dist[vid] = float(cdist[i])
                reach[vid] = step
                heapq.heappush(frontier, (float(cdist[i]), vid))

        ranked = sorted(dist.items(), key=lambda kv: kv[1])
        ids = np.full(k, -1, np.int64)
        steps = np.full(k, -1, np.int64)
        for i in range(min(k, len(ranked))):
            ids[i] = ranked[i][0]
            steps[i] = reach[ranked[i][0]]
        return ids, steps

    def search_knn_batch(self, queries, k, max_step, parallel,
                         benchmarking=False):
        """Sequential per-query loop (SearchKNNBatch, search.go:236-245)."""
        out_ids, out_steps = [], []
        for q in np.asarray(queries, np.float32):
            i, s = self.search_knn(q, k, max_step, parallel, benchmarking)
            out_ids.append(i)
            out_steps.append(s)
        return np.stack(out_ids), np.stack(out_steps)

    def search_knn_concurrent(self, queries, k, max_step, parallel,
                              benchmarking=False):
        """Concurrent form: all queries advance in lockstep and
        each beam step issues ONE oracle batch with every query's fetches.

        Beyond amortizing the per-batch device/RTT cost over Q queries, the
        bigger batch improves the lossy batch-PIR contract: the per-partition
        quota grows to Q*parallel*m/P, so random imbalance drops a smaller
        fraction of fetches than the reference's per-query batches
        (batch-pir.go:194-216). Traversal semantics per query are identical
        to search_knn.
        """
        queries = np.asarray(queries, np.float32)
        Q = queries.shape[0]
        n, dim, m = self.oracle.get_metadata()

        known = [dict() for _ in range(Q)]     # id -> (vec, nbrs)
        dist = [dict() for _ in range(Q)]
        reach = [dict() for _ in range(Q)]
        frontier = [[] for _ in range(Q)]

        if not benchmarking:
            sids, svecs, snbrs = self.start
            sdist = np.sum(
                (svecs[None, :, :] - queries[:, None, :]) ** 2, axis=-1)
            for qi in range(Q):
                order = np.argsort(sdist[qi], kind="stable")
                count = 0
                for j in order:
                    if count >= parallel:
                        break
                    vid = int(sids[j])
                    if vid in known[qi]:
                        continue
                    known[qi][vid] = (svecs[j], snbrs[j])
                    dist[qi][vid] = float(sdist[qi][j])
                    reach[qi][vid] = 0
                    heapq.heappush(frontier[qi], (float(sdist[qi][j]), vid))
                    count += 1

        per_q = parallel * m
        for step in range(max_step):
            batch = np.empty(Q * per_q, np.int64)
            for qi in range(Q):
                pos = qi * per_q
                for _ in range(parallel):
                    if not frontier[qi] or benchmarking:
                        batch[pos : pos + m] = self.rng.integers(0, n, size=m)
                    else:
                        _, v = heapq.heappop(frontier[qi])
                        batch[pos : pos + m] = known[qi][v][1]
                    pos += m

            vecs, nbrs = self.oracle.get_vertex_info(batch)
            if benchmarking:
                continue

            vecs = np.asarray(vecs, np.float32)
            for qi in range(Q):
                sl = slice(qi * per_q, (qi + 1) * per_q)
                v_q, n_q, b_q = vecs[sl], nbrs[sl], batch[sl]
                cdist = _l2(v_q, queries[qi][None, :])
                for i, vid in enumerate(b_q):
                    vid = int(vid)
                    if vid in known[qi]:
                        continue
                    if not np.any(n_q[i] != 0):
                        continue
                    known[qi][vid] = (v_q[i], n_q[i])
                    dist[qi][vid] = float(cdist[i])
                    reach[qi][vid] = step
                    heapq.heappush(frontier[qi], (float(cdist[i]), vid))

        ids = np.full((Q, k), -1, np.int64)
        steps = np.full((Q, k), -1, np.int64)
        for qi in range(Q):
            ranked = sorted(dist[qi].items(), key=lambda kv: kv[1])
            for i in range(min(k, len(ranked))):
                ids[qi, i] = ranked[i][0]
                steps[qi, i] = reach[qi][ranked[i][0]]
        return ids, steps
