"""PianoPIR core protocol — single partition.

Array-shaped re-architecture of /root/reference/pianopir/pir.go. Same protocol
semantics (parameter derivation, hint tables, replacement/refresh mechanics,
budget and failure behavior, message sizes), different computational shape:

  * The client's hint state is struct-of-arrays (flat NumPy/JAX arrays), not
    Go slices-of-slices (pir.go:91-122).
  * Offline preprocessing evaluates the whole PRF offset table
    offsets[tag, chunk] with one bitsliced AES kernel call, then generates
    ALL primary+backup parities with one chunk-streaming XOR-scan kernel
    (ops/xor_scan.py) — the reference's per-hint per-chunk scalar loop
    (pir.go:303-352) becomes two device passes.
  * The offset table is kept client-side, so the online hit-scan
    (pir.go:404-419) and set expansion (pir.go:422-427) are table lookups
    with zero online AES work. This trades client memory for latency; the
    reported storage metric follows the reference's model (pir.go:178-190)
    with the table counted separately (see PianoClient.offset_table_bytes).
  * The online server answer is the same XOR scan (pir.go:65-88) evaluated
    by kernel on device (or NumPy off-device for the host tier).

The local response cache (pir.go:121,381-383,468) is kept on the host.
"""

from __future__ import annotations

import dataclasses
import secrets

import numpy as np

from pacmann.ops import aes
from pacmann.ops.xor_scan import xor_scan_host, xor_scan_xla
from pacmann.pir import layout
from pacmann.pir.params import (
    DEFAULT_PROGRAM_POINT,
    PianoParams,
    derive_piano_params,
)


class QueryError(Exception):
    """Protocol-level online failure (budget exhausted / no hit hint)."""


class PianoServer:
    """Holds the chunk-major DB; answers offset-vector XOR queries.

    Equivalent of PianoPIRServer (pir.go:28-88). `raw` is (db_size, entry_u32)
    u32; device layout per pir/layout.py.
    """

    def __init__(self, params: PianoParams, raw: np.ndarray, device: bool = False):
        assert raw.shape == (params.db_size, params.entry_u32), raw.shape
        self.params = params
        self.raw = raw
        self.k = layout.entry_rows(params.entry_u32)
        self.db = layout.pack_db(raw, params.chunk_size, params.set_size)
        self.device = device
        if device:
            import jax

            self.db = jax.device_put(self.db)

    def non_private_query(self, idx: int) -> np.ndarray:
        p = self.params
        if idx >= p.db_size:
            if idx < p.chunk_size * p.set_size:
                return np.zeros(p.entry_u32, np.uint32)  # padding (pir.go:50-53)
            raise QueryError(f"idx {idx} is out of range")
        return self.raw[idx]

    def private_query_batch(self, offsets: np.ndarray,
                            skip: np.ndarray | None = None) -> np.ndarray:
        """offsets: (B, SetSize) u32 -> (B, entry_u32) u32 XOR answers."""
        offsets = np.asarray(offsets, np.uint32)
        if skip is None:
            skip = np.zeros(offsets.shape, bool)
        if self.device:
            out = np.asarray(
                xor_scan_xla(self.db, offsets, skip, self.k)
            )
        else:
            out = xor_scan_host(self.db, offsets, skip, self.k)
        return out.reshape(offsets.shape[0], self.k * 128)[:, : self.params.entry_u32]

    def private_query(self, offsets: np.ndarray) -> np.ndarray:
        return self.private_query_batch(offsets[None])[0]


@dataclasses.dataclass
class ClientState:
    """Struct-of-arrays hint state (pir.go:91-122)."""

    primary_tag: np.ndarray        # (Hp,) u32 — tag held by each primary slot
    primary_parity: np.ndarray     # (Hp, E) u32
    primary_prog: np.ndarray       # (Hp,) u32, DEFAULT_PROGRAM_POINT = unset
    repl_idx: np.ndarray           # (S, R) u32 — global entry index
    repl_val: np.ndarray           # (S, R, E) u32
    backup_parity: np.ndarray      # (S, R, E) u32; tag of (c, j) = Hp + c*R + j
    histogram: np.ndarray          # (S,) u32 consumed per chunk
    finished: int                  # queries consumed
    offsets: np.ndarray            # (T, S) u32 — PRF(tag, chunk) & mask table


# Below this many PRF evaluations the vectorized NumPy AES beats paying for a
# full fixed-size bitsliced device block (aes.PRF_BLOCK lanes) + transfers.
_HOST_PREP_THRESHOLD = 1 << 15

# Below this many *gathered bytes* the host XOR scan beats a device dispatch
# (performance heuristic only; equals the PRF cutover at entry k=1).
_HOST_SCAN_THRESHOLD_BYTES = 1 << 22


class PianoClient:
    """Stateful PianoPIR client (pir.go:91-471).

    use_device_prep: True = always run PRF/XOR prep on device, False = always
    host NumPy, None = auto (device only when the table is big enough to
    amortize the fixed-size bitsliced AES block).
    """

    def __init__(self, params: PianoParams, use_device_prep: bool | None = None):
        self.params = params
        self.use_device_prep = use_device_prep
        self.skip_prep = False
        self.state: ClientState | None = None
        self.cache: dict[int, np.ndarray] = {}
        self.key: bytes = b"\x00" * 16

    # -- offline ------------------------------------------------------------

    def initialization(self, rng: np.random.Generator | None = None):
        """Reset all hint state and resample the master key (pir.go:203-255)."""
        p = self.params
        rng = rng or np.random.default_rng(secrets.randbits(64))
        self.key = rng.bytes(16)
        self.key_masks = aes.expand_key_planes(self.key)
        E = p.entry_u32
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        self.state = ClientState(
            primary_tag=np.arange(Hp, dtype=np.uint32),
            primary_parity=np.zeros((Hp, E), np.uint32),
            primary_prog=np.full(Hp, DEFAULT_PROGRAM_POINT, np.uint32),
            repl_idx=np.full((S, R), DEFAULT_PROGRAM_POINT, np.uint32),
            repl_val=np.zeros((S, R, E), np.uint32),
            backup_parity=np.zeros((S, R, E), np.uint32),
            histogram=np.zeros(S, np.uint32),
            finished=0,
            offsets=np.zeros((Hp + S * R, S), np.uint32),
        )
        self.cache = {}
        self._rng = rng

    def preprocessing(self, server: PianoServer,
                      rng: np.random.Generator | None = None):
        """Generate all hints: PRF table pass + XOR-scan pass (pir.go:267-352)."""
        self.initialization(rng)
        if self.skip_prep:
            return
        p = self.params
        st = self.state
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        T = Hp + S * R

        # Pass 1: PRF offset table offsets[tag, chunk] (pir.go:318,336).
        st.offsets = self._compute_offset_table(T, S)

        # Pass 2: parities. Primary hints cover every chunk; backup hint group
        # c skips chunk c (pir.go:330-339).
        skip = np.zeros((T, S), bool)
        group = np.repeat(np.arange(S), R)                  # backup tag -> chunk
        skip[Hp:, :] = group[:, None] == np.arange(S)[None, :]
        parities = self._xor_scan(server, st.offsets, skip)
        st.primary_parity = parities[:Hp].copy()
        st.backup_parity = parities[Hp:].reshape(S, R, p.entry_u32).copy()

        # Pass 3: replacements — random (idx, value) per chunk (pir.go:345-349).
        offs = (self._rng.integers(0, 2**32, size=(S, R), dtype=np.uint64)
                & np.uint64(p.chunk_mask)).astype(np.uint32)
        st.repl_idx = offs + (np.arange(S, dtype=np.uint32) * p.chunk_size)[:, None]
        # gather values from the host-resident raw DB; indices past db_size
        # are zero-padding rows (pir.go:285-295)
        idx = st.repl_idx.astype(np.int64).reshape(-1)
        in_range = idx < p.db_size
        vals = np.zeros((S * R, p.entry_u32), np.uint32)
        vals[in_range] = server.raw[idx[in_range]]
        st.repl_val = vals.reshape(S, R, p.entry_u32)

    def _on_device(self, work: int) -> bool:
        if self.use_device_prep is not None:
            return self.use_device_prep
        return work >= _HOST_PREP_THRESHOLD

    def _compute_offset_table(self, T: int, S: int) -> np.ndarray:
        tags = np.arange(T, dtype=np.uint32)
        chunks = np.arange(S, dtype=np.uint32)
        if self._on_device(T * S):
            out = aes.prf_offsets(
                self.key_masks, tags[:, None], chunks[None, :],
                self.params.chunk_mask,
            )
            return np.asarray(out, dtype=np.uint32)
        from pacmann import native_lib

        if native_lib.available():
            rk = native_lib.expand_key(self.key)
            return native_lib.prf_offset_table(
                rk, 0, T, S, self.params.chunk_mask)
        from pacmann.ops import aes_host

        rk = aes_host.expand_key(self.key)
        return (
            aes_host.prf_eval_u64(
                rk, tags.astype(np.uint64)[:, None],
                chunks.astype(np.uint64)[None, :],
            )
            & np.uint64(self.params.chunk_mask)
        ).astype(np.uint32)

    def _xor_scan(self, server: PianoServer, offsets, skip) -> np.ndarray:
        k = server.k
        gathered_bytes = offsets.size * k * 512  # one (k,128)-u32 row per off
        on_device = (self.use_device_prep if self.use_device_prep is not None
                     else gathered_bytes >= _HOST_SCAN_THRESHOLD_BYTES)
        if server.device or on_device:
            out = np.asarray(xor_scan_xla(server.db, offsets, skip, k))
        else:
            out = xor_scan_host(np.asarray(server.db), offsets, skip, k)
        return out.reshape(offsets.shape[0], k * 128)[:, : self.params.entry_u32]

    # -- online -------------------------------------------------------------

    def _backup_tag(self, chunk: int, j: int) -> int:
        return self.params.primary_hint_num + chunk * self.params.max_query_per_chunk + j

    def prepare_dummy(self) -> np.ndarray:
        """Dummy query: SetSize random offsets (pir.go:363-371)."""
        p = self.params
        return (self._rng.integers(0, 2**32, size=p.set_size, dtype=np.uint64)
                & np.uint64(p.chunk_mask)).astype(np.uint32)

    def prepare_query(self, idx: int, exclude_slots=None, pending_hist=None):
        """Phase 1 of one online query (pir.go:354-446): hit scan, set
        expansion, replacement. Returns (ctx, query_set offsets (S,)) or
        (("cached", value), None). Raises QueryError on protocol failure.

        exclude_slots / pending_hist support batched pipelining (engine.py):
        when several sub-queries of one partition are prepared before any is
        finished, slots and replacement groups already reserved by in-flight
        queries must not be reused — the sequential reference gets this for
        free (pir.go runs prepare+finish atomically per query)."""
        p = self.params
        st = self.state

        if idx >= p.db_size:
            raise QueryError(f"idx {idx} is out of range")
        if idx in self.cache:
            return ("cached", self.cache[idx]), None
        n_pending = sum(pending_hist.values()) if pending_hist else 0
        if st.finished + n_pending >= p.max_query_num:
            raise QueryError("exceed the maximum number of queries")

        chunk_id, offset = divmod(idx, p.chunk_size)
        in_flight = pending_hist.get(chunk_id, 0) if pending_hist else 0
        if st.histogram[chunk_id] + in_flight >= p.max_query_per_chunk:
            raise QueryError(f"too many queries in chunk {chunk_id}")

        # hit scan (pir.go:404-419): first primary slot whose PRF offset in
        # chunk_id equals offset and isn't already programmed in this chunk.
        col = st.offsets[st.primary_tag, chunk_id]
        eligible = (col == offset) & (
            (st.primary_prog == DEFAULT_PROGRAM_POINT)
            | (st.primary_prog // p.chunk_size != chunk_id)
        )
        if exclude_slots:
            eligible[list(exclude_slots)] = False
        hits = np.flatnonzero(eligible)
        if hits.size == 0:
            raise QueryError("no hit hint in the primary hint table")
        hit = int(hits[0])

        # expand to a full set (pir.go:422-427) — table row lookup
        query_set = st.offsets[st.primary_tag[hit]].copy()  # offsets per chunk
        # enforce programmed point (pir.go:430-433)
        prog = int(st.primary_prog[hit])
        if prog != DEFAULT_PROGRAM_POINT:
            query_set[prog // p.chunk_size] = prog % p.chunk_size
        # replacement for the queried chunk (pir.go:436-439); in-flight
        # queries in the same chunk have reserved earlier groups
        in_group = int(st.histogram[chunk_id]) + in_flight
        repl_idx = int(st.repl_idx[chunk_id, in_group])
        query_set[chunk_id] = repl_idx % p.chunk_size

        return ("live", idx, chunk_id, in_group, hit), query_set

    def finish_query(self, ctx, response: np.ndarray) -> np.ndarray:
        """Phase 2: un-mask the server answer and refresh the spent hint from
        a backup (pir.go:451-468)."""
        if ctx[0] == "cached":
            return ctx[1]
        _, idx, chunk_id, in_group, hit = ctx
        st = self.state
        repl_val = st.repl_val[chunk_id, in_group]

        # un-mask (pir.go:451-453)
        response = response ^ repl_val ^ st.primary_parity[hit]

        # refresh from backup (pir.go:460-463)
        st.primary_tag[hit] = self._backup_tag(chunk_id, in_group)
        st.primary_parity[hit] = st.backup_parity[chunk_id, in_group] ^ response
        st.primary_prog[hit] = idx

        st.finished += 1
        st.histogram[chunk_id] += 1
        self.cache[idx] = response
        return response

    def query(self, idx: int, server: PianoServer, real: bool = True) -> np.ndarray:
        """One online query (pir.go:354-471). Raises QueryError on protocol
        failure (budget exhausted / no hit hint), matching the reference's
        error returns; callers that want the zero-entry contract catch it."""
        if not real:
            server.private_query(self.prepare_dummy())
            return np.zeros(self.params.entry_u32, np.uint32)
        ctx, query_set = self.prepare_query(idx)
        if ctx[0] == "cached":
            return ctx[1]
        response = server.private_query(query_set)
        return self.finish_query(ctx, response)

    # -- accounting ---------------------------------------------------------

    def local_storage_bytes(self) -> float:
        return self.params.local_storage_bytes()

    def offset_table_bytes(self) -> int:
        """Extra client memory for the online PRF table (not in the reference
        model; see module docstring)."""
        return int(self.state.offsets.size * 4) if self.state is not None else 0


class PianoPIR:
    """Client+server wrapper (pir.go:473-548)."""

    def __init__(self, db_size: int, entry_bytes: int, raw: np.ndarray,
                 failure_prob_log2: int, device: bool = False,
                 use_device_prep: bool | None = None):
        self.params = derive_piano_params(db_size, entry_bytes, failure_prob_log2)
        if raw.dtype != np.uint32:
            raise ValueError("raw DB must be uint32 (entry-major)")
        raw = raw.reshape(db_size, self.params.entry_u32)
        self.server = PianoServer(self.params, raw, device=device)
        self.client = PianoClient(self.params, use_device_prep=use_device_prep)

    def preprocessing(self, rng=None):
        self.client.preprocessing(self.server, rng=rng)

    def dummy_preprocessing(self, rng=None):
        self.client.initialization(rng)
        self.client.skip_prep = True

    def query(self, idx: int, real: bool = True) -> np.ndarray:
        # auto re-prep on exhaustion (pir.go:525-533)
        if self.client.state.finished == self.params.max_query_num:
            self.client.preprocessing(self.server)
        return self.client.query(idx, self.server, real)

    def local_storage_size(self) -> float:
        return self.params.local_storage_bytes()

    def comm_cost_per_query(self) -> float:
        return self.params.comm_cost_per_query_bytes()
