"""Multi-chip batch PIR: partition-parallel sharding of the device engine.

Scale tier (SURVEY.md §7 step 9 / BASELINE config 5): the batch-PIR layer's
natural parallel axis is its partitions — each is an independent PianoPIR
with its own sub-DB, keys, hints, and budget (batch-pir.go:62-85). So the
multi-chip engine shards the partition axis of EVERYTHING (DB, tag tables,
parities, replacements, budgets) across a 1-D jax.sharding.Mesh:

    db           (S, P, C*k, 128)   sharded on axis 1
    state leaves (P, ...)           sharded on axis 0
    idx_q        (Q, P)             sharded on axis 1

Shard-native END TO END: the packed DB is assembled from per-device host
blocks (jax.make_array_from_single_device_arrays), and the offline phase
runs `_prep_fused` under shard_map — each card preps ITS partitions only,
the reference's independent per-partition preprocessing
(batch-pir.go:130-148) as SPMD. No device (and no single host buffer) ever
materializes more than one shard of the DB or hint state, so the DB a mesh
serves grows with its cards, and hint generation scales linearly with
them.

The online batch runs the SAME `_online_core` as the single-card engine
under shard_map — every card serves its own partitions' sub-queries with
ZERO collectives in the hot path (the reference's goroutine-per-partition
parallelism, reborn as SPMD). Only the decoded entries are gathered.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P_

from pacmann.ops import aes
from pacmann.pir.device_engine import (
    DevicePianoEngine,
    _online_core,
    _prep_fused,
)

AXIS = "shard"


class ShardedPianoEngine(DevicePianoEngine):
    """DevicePianoEngine with the partition axis sharded over a mesh."""

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw: np.ndarray, failure_prob_log2: int, mesh,
                 verbose: bool = False, table_free: bool = False):
        self.mesh = mesh
        self._sharded_step = None
        self._sharded_prep = None
        super().__init__(db_size, entry_bytes, batch_size, raw,
                         failure_prob_log2, verbose=verbose,
                         table_free=table_free)
        self._state_sharding = {
            "table": P_(AXIS, None, None),
            "masks": P_(AXIS, None, None, None),
            "slot_col": P_(AXIS, None, None),
            "tag": P_(AXIS, None),
            "prog": P_(AXIS, None),
            "primary_parity": P_(AXIS, None, None),
            "backup_parity": P_(AXIS, None, None),
            "hist": P_(AXIS, None),
            "finished": P_(AXIS),
            "repl_idx": P_(AXIS, None, None),
            "repl_val": P_(AXIS, None, None, None),
        }

    # -- shard-native DB placement -------------------------------------------

    def _pack_db(self, raw):
        """Pack each device's partitions into its own host block and place
        it on that device before assembly — per-device AND per-host-buffer
        peak is one shard, never the full DB (batch-pir.go:130-148's
        independent partitions)."""
        mesh = self.mesh
        n_dev = mesh.shape[AXIS]
        P = self.config.partition_num
        assert P % n_dev == 0, (P, n_dev)
        per = P // n_dev
        devs = mesh.devices.reshape(-1)
        shards = [
            jax.device_put(
                self._pack_partitions(raw, d * per, (d + 1) * per), devs[d])
            for d in range(n_dev)
        ]
        p = self.params
        shape = (p.set_size, P, p.chunk_size * self.k, 128)
        return jax.make_array_from_single_device_arrays(
            shape, NamedSharding(mesh, P_(None, AXIS, None, None)), shards)

    # -- shard-native offline phase ------------------------------------------

    def _prep_device(self, keys16, repl_off):
        """The offline phase under shard_map: each card runs the fused prep
        program (PRF tables + hint scan + replacements + slot columns) over
        ITS partitions only. Runs the device program on every backend — it
        is the shard_map-able form (the host-AES path of the base class is
        not); CPU meshes only arise in tests and rehearsals."""
        mesh = self.mesh
        p = self.params
        S, R, Hp, C = (p.set_size, p.max_query_per_chunk,
                       p.primary_hint_num, p.chunk_size)
        T = Hp + S * R
        masks = np.stack([aes.expand_key_planes(kb) for kb in keys16])
        ns = lambda *spec: NamedSharding(mesh, P_(*spec))
        masks_d = jax.device_put(
            jnp.asarray(masks), ns(AXIS, None, None, None))
        repl_d = jax.device_put(jnp.asarray(repl_off), ns(AXIS, None, None))

        if self._sharded_prep is None:
            kw = dict(T=T, S=S, C=C, Hp=Hp, R=R, k=self.k,
                      chunk_mask=p.chunk_mask)

            def shard_fn(db4, masks, repl_off):
                return _prep_fused(db4, masks, repl_off, **kw)

            self._sharded_prep = jax.jit(jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P_(None, AXIS, None, None),
                          P_(AXIS, None, None, None),
                          P_(AXIS, None, None)),
                out_specs=(P_(AXIS, None, None), P_(AXIS, None, None),
                           P_(AXIS, None, None, None), P_(AXIS, None, None)),
                check_vma=False,
            ))
        return self._sharded_prep(self.db, masks_d, repl_d)

    def _shard_state(self):
        m = self.mesh
        self.state = {
            k: jax.device_put(v, NamedSharding(m, self._state_sharding[k]))
            for k, v in self.state.items()
        }

    def preprocessing(self, rng=None):
        # _prep_device runs shard-mapped, so the big leaves come out already
        # partition-sharded; this pins the small host-built leaves too.
        super().preprocessing(rng=rng)
        self._shard_state()

    def dummy_preprocessing(self, rng=None):
        super().dummy_preprocessing(rng=rng)
        self._shard_state()

    def _make_sharded_step(self, consts):
        mesh = self.mesh
        state_specs = self._state_sharding

        core = functools.partial(_online_core, **consts)
        # spec pytrees must mirror the ACTUAL state dict (table-free mode
        # carries "masks" instead of "table")
        live = {k: state_specs[k] for k in self.state}
        smapped = jax.shard_map(
            core,
            mesh=mesh,
            in_specs=(P_(None, AXIS, None, None),       # db
                      live,
                      P_(None, AXIS),                   # idx_q
                      P_(None, AXIS, None)),            # rand_offs
            out_specs=(live,
                       P_(None, AXIS, None),            # entries
                       P_(None, AXIS)),                 # oks
            check_vma=False,
        )
        return jax.jit(smapped, donate_argnums=(1,))

    def _online(self, idx_q, rand_offs):
        """Shard-mapped batch step (overrides the single-chip jit)."""
        from pacmann.pir.params import DEFAULT_PROGRAM_POINT

        if self._sharded_step is None:
            p = self.params
            self._sharded_step = self._make_sharded_step(dict(
                C=p.chunk_size, R=p.max_query_per_chunk,
                Hp=p.primary_hint_num, S=p.set_size, k=self.k,
                max_q=p.max_query_num, dpp=DEFAULT_PROGRAM_POINT))
        return self._sharded_step(self.db, self.state, idx_q, rand_offs)


# ---------------------------------------------------------------------------
# Chunk-axis sharding: P < n_devices


class ChunkShardedPianoEngine(DevicePianoEngine):
    """SetSize(chunk)-axis sharded engine — for meshes with MORE devices
    than batch partitions (P < n_devices), where partition sharding cannot
    use the machine.

    SURVEY §5's "sequence-parallel analog", now INSIDE the engine: the
    XOR-parity computations (offline hint generation pir.go:303-352 and
    the online server scan pir.go:65-88) shard the chunk axis S of the DB
    across the mesh — each device streams only ITS chunks and XORs
    PRF-selected rows into partial parities, and partials combine with an
    XOR all-reduce across the cards (XOR over disjoint chunk sets composes,
    like ring-reduced partial sums). The client-side protocol phases
    (select/finish) are tiny and compute REPLICATED, so client state needs
    no collectives and stays bit-identical to the single-chip engine.

    Per-device DB memory is one S-shard; client state (tables, parities,
    replacements) is replicated — this engine targets small-partition
    configs (the big-DB tier is partition-sharded, ShardedPianoEngine).
    Requires S % n_devices == 0 (S is a multiple of 4 by derivation).
    """

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw: np.ndarray, failure_prob_log2: int, mesh,
                 verbose: bool = False):
        self.mesh = mesh
        self._sharded_step = None
        super().__init__(db_size, entry_bytes, batch_size, raw,
                         failure_prob_log2, verbose=verbose)
        n_dev = mesh.shape[AXIS]
        S = self.params.set_size
        if S % n_dev:
            raise ValueError(
                f"chunk sharding needs SetSize divisible by the mesh: "
                f"S={S}, devices={n_dev}")

    def _pack_db(self, raw):
        """Host pack, then split the chunk axis across the mesh (the host
        briefly holds the packed DB: this engine targets small-partition
        configs where that is cheap; use ShardedPianoEngine for the
        big-memory tier)."""
        db = super()._pack_db(raw)
        return jax.device_put(
            db, NamedSharding(self.mesh, P_(AXIS, None, None, None)))

    def _prep_device(self, keys16, repl_off):
        """Offline phase, chunk-sharded: each device PRF-generates the
        offset columns of ITS chunks (per-partition-keyed fused bitsliced
        AES), scans ITS chunk shard into partial parities, and the partials
        XOR-all-reduce; replacement values gather locally and all_gather.
        Bit-identical to the single-chip engine: XOR is order-free and the
        PRF lattice values are the same."""
        from pacmann.parallel.sharding import _xor_allreduce
        from pacmann.pir.device_engine import (
            _build_skip, _gather_repl, _hint_scan, _off_dtype)

        mesh = self.mesh
        n_dev = mesh.shape[AXIS]
        p = self.params
        P = self.config.partition_num
        S, R, Hp, C = (p.set_size, p.max_query_per_chunk,
                       p.primary_hint_num, p.chunk_size)
        T = Hp + S * R
        S_loc = S // n_dev
        k = self.k
        Ep = self.Ep
        chunk_mask = p.chunk_mask
        masks = jnp.asarray(
            np.stack([aes.expand_key_planes(kb) for kb in keys16]))
        ns = lambda *spec: NamedSharding(mesh, P_(*spec))
        masks_d = jax.device_put(masks, ns())
        repl_d = jax.device_put(jnp.asarray(repl_off), ns(None, AXIS, None))

        def shard_fn(db_loc, masks, repl_loc):
            s0 = jax.lax.axis_index(AXIS).astype(jnp.uint32) * np.uint32(S_loc)
            # local offset columns: PRF(key_p, t, s) for s in [s0, s0+S_loc)
            tags = jnp.broadcast_to(
                jnp.arange(T, dtype=jnp.uint32)[:, None],
                (T, S_loc)).reshape(-1)
            xs = jnp.broadcast_to(
                s0 + jnp.arange(S_loc, dtype=jnp.uint32)[None, :],
                (T, S_loc)).reshape(-1)
            tbl_loc = aes.prf_eval_fused(
                masks,
                jnp.broadcast_to(tags[None], (P, T * S_loc)),
                jnp.broadcast_to(xs[None], (P, T * S_loc)),
                chunk_mask).reshape(P, T, S_loc)
            skip = _build_skip(P, T, Hp, R, S).reshape(P, T, S)
            skip_loc = jax.lax.dynamic_slice_in_dim(
                skip, s0.astype(jnp.int32), S_loc, 2)
            partial = _hint_scan(db_loc, tbl_loc, skip_loc, k)
            parities = _xor_allreduce(partial)           # (P, T, Ep)
            rv_loc = _gather_repl(db_loc, repl_loc, k=k, Ep=Ep)
            repl_val = jax.lax.all_gather(
                rv_loc, AXIS, axis=1, tiled=True)        # (P, S, R, Ep)
            table = jax.lax.all_gather(
                tbl_loc, AXIS, axis=2, tiled=True)       # (P, T, S)
            od = _off_dtype(C)
            slot_col = jnp.swapaxes(table[:, :Hp, :], 1, 2).astype(od)
            return table.astype(od), parities, repl_val, slot_col

        fn = jax.jit(jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P_(AXIS, None, None, None), P_(), P_(None, AXIS, None)),
            out_specs=(P_(), P_(), P_(), P_()),
            check_vma=False,
        ))
        return fn(self.db, masks_d, repl_d)

    def _make_sharded_step(self, consts):
        from pacmann.ops.xor_scan import xor_gather_multi
        from pacmann.parallel.sharding import _xor_allreduce
        from pacmann.pir.device_engine import _pir_finish, _pir_select

        mesh = self.mesh
        n_dev = mesh.shape[AXIS]
        S = self.params.set_size
        S_loc = S // n_dev
        k = self.k
        Ep = self.Ep
        sel_kw = dict(C=consts["C"], R=consts["R"], Hp=consts["Hp"],
                      S=consts["S"], k=consts["k"], max_q=consts["max_q"],
                      dpp=consts["dpp"])
        fin_kw = dict(C=consts["C"], R=consts["R"], Hp=consts["Hp"],
                      S=consts["S"], k=consts["k"], dpp=consts["dpp"])

        def online_loc(db_loc, state, idx_q, rnd):
            carry = (state["tag"], state["prog"], state["primary_parity"],
                     state["slot_col"], state["hist"], state["finished"])
            # client select: replicated (deterministic, tiny)
            sel, qs = _pir_select(state.get("table"), state["repl_idx"],
                                  carry, idx_q, rnd,
                                  masks=state.get("masks"), **sel_kw)
            # server scan: each device XORs ITS chunks' rows, then the
            # partial parities combine with an XOR all-reduce
            s0 = jax.lax.axis_index(AXIS).astype(jnp.int32) * S_loc
            qs_loc = jax.lax.dynamic_slice_in_dim(qs, s0, S_loc, 2)
            partial = xor_gather_multi(db_loc, qs_loc, k)
            Q, P = idx_q.shape
            resp = _xor_allreduce(partial).reshape(Q, P, Ep)
            # client finish: replicated
            carry, entries, oks = _pir_finish(
                state["repl_val"], state["backup_parity"],
                state.get("table"), carry, sel, resp, **fin_kw)
            tag, prog, ppar, slot_col, hist, finished = carry
            new_state = dict(state, tag=tag, prog=prog, primary_parity=ppar,
                             slot_col=slot_col, hist=hist, finished=finished)
            return new_state, entries, oks

        live = {key: P_() for key in self.state}
        smapped = jax.shard_map(
            online_loc,
            mesh=mesh,
            in_specs=(P_(AXIS, None, None, None), live, P_(), P_()),
            out_specs=(live, P_(), P_()),
            check_vma=False,
        )
        return jax.jit(smapped, donate_argnums=(1,))

    def _online(self, idx_q, rand_offs):
        from pacmann.pir.params import DEFAULT_PROGRAM_POINT

        if self._sharded_step is None:
            p = self.params
            self._sharded_step = self._make_sharded_step(dict(
                C=p.chunk_size, R=p.max_query_per_chunk,
                Hp=p.primary_hint_num, S=p.set_size, k=self.k,
                max_q=p.max_query_num, dpp=DEFAULT_PROGRAM_POINT))
        return self._sharded_step(
            self.db, self.state, jnp.asarray(idx_q), jnp.asarray(rand_offs))
