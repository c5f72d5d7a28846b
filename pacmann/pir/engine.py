"""Fused batch-PIR engine — all partitions in one device program.

SimpleBatchPianoPIR (pir/batch.py) mirrors the reference's structure: one
independent PianoPIR per partition, looped on the host
(/root/reference/pianopir/batch-pir.go:77-85,130-148,203-205). On a device
that shape is wrong: 16 small kernel launches per batch and per prep pass
waste the card. This engine keeps the *protocol* identical per partition (same
parameter derivation, same per-partition keys/hints/budgets, same lossy batch
contract) but fuses the *computation*:

  * The P partition DBs are stacked chunk-major into ONE device array
      db_f: (S, P*C*k, 128) u32
    chunk s holds every partition's chunk s; a local offset `o` in partition
    `p` is the global row block `p*C + o`. XOR scans for ALL partitions —
    offline hint generation (P*T parity rows) and a whole online batch
    (P*queryNumToMake sub-queries) — are then each ONE xor_scan call.
  * PRF offset tables still use per-partition AES keys; each table is one
    batched bitsliced-AES evaluation.

Equal partition sizing: the DB is zero-padded so every partition has
ceil(n/P) entries and shares one parameter set. Queries never touch padding
(ids < n); replacement samples that land on padding read zeros, matching the
reference's padded-chunk semantics (pir.go:285-295).
"""

from __future__ import annotations

import time

import numpy as np

from pacmann.ops.xor_scan import xor_scan_host, xor_scan_xla
from pacmann.pir import layout
from pacmann.pir.params import (
    DEFAULT_VALUE,
    QUERY_PER_PARTITION,
    derive_batch_params,
    derive_piano_params,
)
from pacmann.pir.piano import PianoClient, QueryError


class FusedBatchPianoPIR:
    """Drop-in replacement for SimpleBatchPianoPIR with fused device compute."""

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw: np.ndarray, failure_prob_log2: int,
                 device: bool = True, verbose: bool = False):
        entry_u32 = entry_bytes // 4
        raw = raw.reshape(db_size, entry_u32)
        self.config = derive_batch_params(
            db_size, entry_bytes, batch_size, failure_prob_log2
        )
        c = self.config
        self.verbose = verbose
        self.device = device
        P, psize = c.partition_num, c.partition_size
        self.params = derive_piano_params(psize, entry_bytes, failure_prob_log2)
        p = self.params

        # zero-pad to equal partitions and stack chunk-major
        padded = np.zeros((P * psize, entry_u32), np.uint32)
        padded[:db_size] = raw
        self.raw = padded                      # (P*psize, E) host copy
        self.k = layout.entry_rows(entry_u32)
        blocks = [
            layout.pack_db(padded[i * psize:(i + 1) * psize],
                           p.chunk_size, p.set_size)
            for i in range(P)
        ]
        db_f = np.concatenate(blocks, axis=1)  # (S, P*C*k, 128)
        if device:
            import jax

            self.db = jax.device_put(db_f)
        else:
            self.db = db_f

        self.clients = [PianoClient(p) for _ in range(P)]

        # stats (batch-pir.go:44-53)
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        self.support_batch_num = 0
        self.preprocessing_time = 0.0
        self.comm_cost_per_batch_offline = 0
        self._skip_prep = False

    # -- helpers -------------------------------------------------------------

    def _xor(self, offsets: np.ndarray, skip: np.ndarray) -> np.ndarray:
        """One fused scan: offsets (B, S) are *global* row blocks p*C + o."""
        if self.device:
            out = np.asarray(xor_scan_xla(
                self.db, np.ascontiguousarray(offsets),
                np.ascontiguousarray(skip), self.k))
        else:
            out = xor_scan_host(self.db, offsets, skip, self.k)
        return out.reshape(offsets.shape[0], self.k * 128)[
            :, : self.params.entry_u32]

    # -- offline -------------------------------------------------------------

    def _record_stats(self, prep_time: float):
        self.preprocessing_time = prep_time
        self.support_batch_num = self.params.max_query_num // QUERY_PER_PARTITION
        db_bytes = float(self.config.db_size) * self.config.entry_bytes
        self.comm_cost_per_batch_offline = int(db_bytes / self.support_batch_num)

    def preprocessing(self, rng: np.random.Generator | None = None):
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        self._skip_prep = False
        t0 = time.perf_counter()

        p = self.params
        c = self.config
        P = c.partition_num
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        T = Hp + S * R
        C = p.chunk_size

        # per-partition skip pattern is identical: backup group g skips chunk g
        skip1 = np.zeros((T, S), bool)
        group = np.repeat(np.arange(S), R)
        skip1[Hp:, :] = group[:, None] == np.arange(S)[None, :]
        skip = np.tile(skip1, (P, 1))

        glob_off = np.empty((P * T, S), np.uint32)
        for i, cl in enumerate(self.clients):
            cl.initialization(rng)
            st = cl.state
            st.offsets = cl._compute_offset_table(T, S)
            glob_off[i * T:(i + 1) * T] = (
                st.offsets + np.uint32(i * C)
            )

        parities = self._xor(glob_off, skip)     # (P*T, E)

        psize = c.partition_size
        for i, cl in enumerate(self.clients):
            st = cl.state
            part = parities[i * T:(i + 1) * T]
            st.primary_parity = part[:Hp].copy()
            st.backup_parity = part[Hp:].reshape(S, R, p.entry_u32).copy()
            # replacements from the host raw copy (pir.go:345-349)
            offs = (cl._rng.integers(0, 2**32, size=(S, R), dtype=np.uint64)
                    & np.uint64(p.chunk_mask)).astype(np.uint32)
            st.repl_idx = offs + (np.arange(S, dtype=np.uint32) * C)[:, None]
            idx = st.repl_idx.astype(np.int64).reshape(-1)
            in_range = idx < psize
            vals = np.zeros((S * R, p.entry_u32), np.uint32)
            vals[in_range] = self.raw[i * psize + idx[in_range]]
            st.repl_val = vals.reshape(S, R, p.entry_u32)

        self._record_stats(time.perf_counter() - t0)

    def dummy_preprocessing(self, rng=None):
        for cl in self.clients:
            cl.initialization(rng)
            cl.skip_prep = True
        self._skip_prep = True
        self._record_stats(0.0)

    # -- online --------------------------------------------------------------

    def query(self, ids) -> np.ndarray:
        """Batched oblivious fetch with the reference's lossy FCFS contract
        (batch-pir.go:170-248): quota len(ids)/P per partition, dummy padding,
        overflow dropped to zeros — but ONE fused server scan per batch."""
        c = self.config
        p = self.params
        C = p.chunk_size
        ids = [int(i) for i in ids]
        quota = len(ids) // c.partition_num

        partition_queries: list[list[int]] = [
            [] for _ in range(c.partition_num)]
        for idx in ids:
            partition_queries[idx // c.partition_size].append(idx)

        # phase 1: prepare every sub-query client-side. In-flight sub-queries
        # of one partition reserve their hint slot, replacement group, and
        # index (the sequential reference's per-query atomicity, pipelined).
        offsets_rows = []
        pending = []          # (partition, ctx, global idx) aligned with rows
        responses: dict[int, np.ndarray] = {}
        for i in range(c.partition_num):
            pq = partition_queries[i]
            while len(pq) < quota:
                pq.append(DEFAULT_VALUE)
            cl = self.clients[i]
            used_slots: set[int] = set()
            pend_hist: dict[int, int] = {}
            in_flight_idx: set[int] = set()
            for j in range(quota):
                if pq[j] == DEFAULT_VALUE:
                    offsets_rows.append(cl.prepare_dummy() + np.uint32(i * C))
                    pending.append(None)
                    continue
                gidx = pq[j]
                if gidx in in_flight_idx:
                    # duplicate of an in-flight query: the sequential
                    # reference serves it from cache (pir.go:381-383)
                    offsets_rows.append(cl.prepare_dummy() + np.uint32(i * C))
                    pending.append(None)
                    continue
                try:
                    ctx, qset = cl.prepare_query(
                        gidx - i * c.partition_size,
                        exclude_slots=used_slots, pending_hist=pend_hist)
                except QueryError:
                    pending.append(None)          # -> zeros
                    offsets_rows.append(cl.prepare_dummy() + np.uint32(i * C))
                    continue
                if ctx[0] == "cached":
                    responses[gidx] = ctx[1]
                    # keep the fixed access pattern: send a dummy row anyway
                    offsets_rows.append(cl.prepare_dummy() + np.uint32(i * C))
                    pending.append(None)
                else:
                    _, _, chunk_id, _, hit = ctx
                    used_slots.add(hit)
                    pend_hist[chunk_id] = pend_hist.get(chunk_id, 0) + 1
                    in_flight_idx.add(gidx)
                    offsets_rows.append(qset + np.uint32(i * C))
                    pending.append((i, ctx, gidx))

        # phase 2: one fused server scan
        if offsets_rows:
            batch_off = np.stack(offsets_rows)
            skip = np.zeros(batch_off.shape, bool)
            answers = self._xor(batch_off, skip)
        else:
            answers = np.zeros((0, p.entry_u32), np.uint32)

        # phase 3: unmask + hint refresh
        for row, item in enumerate(pending):
            if item is None:
                continue
            i, ctx, gidx = item
            responses[gidx] = self.clients[i].finish_query(ctx, answers[row])

        entry_u32 = c.entry_bytes // 4
        out = np.zeros((len(ids), entry_u32), np.uint32)
        for r, idx in enumerate(ids):
            if idx in responses:
                out[r] = responses[idx]

        # budget bookkeeping + auto re-prep (batch-pir.go:239-245)
        if self.queries_made_in_partition >= p.max_query_num - 2:
            if self.verbose:
                print(f"Redo preprocessing after {self.finished_batch_num} batches")
            self.preprocessing()
        else:
            self.finished_batch_num += len(ids) // c.batch_size
            self.queries_made_in_partition += quota

        return out

    # -- accounting (batch-pir.go:250-276) -----------------------------------

    def local_storage_size(self) -> float:
        return self.params.local_storage_bytes() * self.config.partition_num

    def extra_storage_size(self) -> float:
        """Resident PRF offset tables beyond the reference storage model."""
        return float(sum(cl.offset_table_bytes() for cl in self.clients))

    def comm_cost_per_batch_online(self) -> int:
        return int(self.params.comm_cost_per_query_bytes()
                   * QUERY_PER_PARTITION * self.config.partition_num)
