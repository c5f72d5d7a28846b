"""Simple batch PIR — partitioned PianoPIR with the reference's lossy contract.

Re-architecture of /root/reference/pianopir/batch-pir.go. Semantics preserved
exactly:
  * PartitionNum = BatchSize/2 contiguous partitions, one independent
    PianoPIR per partition (batch-pir.go:62-85).
  * Query([ids]): each partition answers exactly len(ids)/PartitionNum
    sub-queries — short partitions are padded with dummy queries, overflow
    queries are silently dropped and answered with zeros
    (batch-pir.go:175-235); sub-query errors also become zeros.
  * Budget tracking + auto re-preprocessing near exhaustion
    (batch-pir.go:239-245) and the analytic storage/comm cost model
    (batch-pir.go:250-268).

Device shape: partitions are the structural parallel axis. Preprocessing runs
all partitions' PRF-table and XOR-scan passes on device (per partition here;
pir/engine.py fuses equal-sized partitions into single batched kernels and
shards them over the mesh).
"""

from __future__ import annotations

import time

import numpy as np

from pacmann.pir.params import (
    DEFAULT_VALUE,
    QUERY_PER_PARTITION,
    derive_batch_params,
)
from pacmann.pir.piano import PianoPIR, QueryError


class SimpleBatchPianoPIR:
    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw: np.ndarray, failure_prob_log2: int,
                 device: bool = False, verbose: bool = False):
        entry_u32 = entry_bytes // 4
        raw = raw.reshape(db_size, entry_u32)
        self.config = derive_batch_params(
            db_size, entry_bytes, batch_size, failure_prob_log2
        )
        self.verbose = verbose
        c = self.config
        self.sub_pir: list[PianoPIR] = []
        for i in range(c.partition_num):
            start, end = c.partition_range(i)
            self.sub_pir.append(
                PianoPIR(end - start, entry_bytes, raw[start:end],
                         failure_prob_log2, device=device)
            )

        # stats (batch-pir.go:44-53)
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        self.support_batch_num = 0
        self.preprocessing_time = 0.0
        self.comm_cost_per_batch_offline = 0

    # -- offline ------------------------------------------------------------

    def _record_stats(self, prep_time: float):
        self.preprocessing_time = prep_time
        # min over partitions: robust if partition sizes ever diverge
        # (today they are equal, so this matches the reference's use of [0])
        self.support_batch_num = (
            min(s.params.max_query_num for s in self.sub_pir)
            // QUERY_PER_PARTITION
        )
        db_bytes = float(self.config.db_size) * self.config.entry_bytes
        self.comm_cost_per_batch_offline = int(db_bytes / self.support_batch_num)

    # fork-join prep parallelism over partitions, matching the reference's
    # 8 goroutines (batch-pir.go:130-148). NumPy releases the GIL in the
    # hint-scan kernels, so threads overlap on multi-core hosts.
    THREAD_NUM = 8

    def preprocessing(self, rng: np.random.Generator | None = None):
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        t0 = time.perf_counter()
        # a shared Generator is not thread-safe: spawn one independent
        # child stream per partition (deterministic given the parent)
        rngs = (rng.spawn(len(self.sub_pir)) if rng is not None
                else [None] * len(self.sub_pir))
        if self.THREAD_NUM > 1 and len(self.sub_pir) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.THREAD_NUM) as pool:
                list(pool.map(lambda sr: sr[0].preprocessing(rng=sr[1]),
                              zip(self.sub_pir, rngs)))
        else:
            for sub, r in zip(self.sub_pir, rngs):
                sub.preprocessing(rng=r)
        self._record_stats(time.perf_counter() - t0)

    def dummy_preprocessing(self, rng=None):
        for sub in self.sub_pir:
            sub.dummy_preprocessing(rng=rng)
        self._record_stats(0.0)

    # -- online -------------------------------------------------------------

    def query(self, ids) -> np.ndarray:
        """Batch query -> (len(ids), entry_u32) u32, zeros for dropped/failed.

        Mirrors batch-pir.go:170-248 including FCFS overflow drop.
        """
        c = self.config
        ids = [int(i) for i in ids]
        query_num_to_make = len(ids) // c.partition_num

        partition_queries: list[list[int]] = [[] for _ in range(c.partition_num)]
        for idx in ids:
            partition_queries[idx // c.partition_size].append(idx)

        responses: dict[int, np.ndarray] = {}
        for i in range(c.partition_num):
            pq = partition_queries[i]
            while len(pq) < query_num_to_make:
                pq.append(DEFAULT_VALUE)
            for j in range(query_num_to_make):
                if pq[j] == DEFAULT_VALUE:
                    self.sub_pir[i].query(0, real=False)
                else:
                    try:
                        responses[pq[j]] = self.sub_pir[i].query(
                            pq[j] - i * c.partition_size, real=True
                        )
                    except QueryError:
                        pass  # swallowed -> zeros (batch-pir.go:205-213)

        entry_u32 = c.entry_bytes // 4
        out = np.zeros((len(ids), entry_u32), np.uint32)
        for r, idx in enumerate(ids):
            if idx in responses:
                out[r] = responses[idx]

        # budget bookkeeping + auto re-prep (batch-pir.go:239-245);
        # min over partitions so no partition can exceed its own budget
        if (self.queries_made_in_partition
                >= min(s.params.max_query_num for s in self.sub_pir) - 2):
            if self.verbose:
                print(f"Redo preprocessing after {self.finished_batch_num} batches")
            self.preprocessing()
        else:
            self.finished_batch_num += len(ids) // c.batch_size
            self.queries_made_in_partition += query_num_to_make

        return out

    # -- accounting (batch-pir.go:250-276) ----------------------------------

    def local_storage_size(self) -> float:
        return sum(s.local_storage_size() for s in self.sub_pir)

    def extra_storage_size(self) -> float:
        """Resident PRF offset tables beyond the reference storage model."""
        return float(sum(s.client.offset_table_bytes() for s in self.sub_pir))

    def comm_cost_per_batch_online(self) -> int:
        return int(sum(s.comm_cost_per_query() * QUERY_PER_PARTITION
                       for s in self.sub_pir))
