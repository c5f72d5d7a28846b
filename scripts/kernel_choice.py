"""Time the candidate forms of the two offline-phase operations at the
SIFT1M shape on the accelerator, and check that they agree bit for bit.

  PRF tables (P * T * S AES-MMO evaluations per hint refresh):
    dev_fused  all partitions in one bitsliced program (_prf_tables_fused)
    dev_map    lax.map of aes._prf_table_on_device over the partitions
               (the engine's form, device_engine._prf_tables)
    host       native AES-NI tables on the host, then uploaded
  Hint scan (P * T * S row gathers XORed into (P, T, k*128) parities):
    scan_cN    xor_scan_parts, lax.scan over chunks, N chunks per step (the
               engine's form is device_engine._hint_scan)
    gather_bN  flat gather + XOR-reduce, N hints a block (_hintgen_gather)

The two forms the engine does not use are defined here, so the choice can
be measured again on another card or shape.

Usage: python scripts/kernel_choice.py [--n 1000000] [--reps 5]
Prints one JSON line per form and writes chiprun_out/kernel_choice.json.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pacmann.ops.aes import (  # noqa: E402
    _mix_columns, _pack_words, _shift_rows, _sub_bytes)
from pacmann.ops.bitops import transpose32  # noqa: E402


@functools.partial(jax.jit, static_argnames=("T", "S", "chunk_mask"))
def _prf_tables_fused(masks, T: int, S: int, chunk_mask: int):
    P = masks.shape[0]
    n = T * S
    pad = (n + 255) // 256 * 256
    L = pad // 32
    i = jax.lax.broadcasted_iota(jnp.uint32, (pad, 1), 0)[:, 0]
    tags = i // np.uint32(S)
    lo = i % np.uint32(S)
    hi = tags << np.uint32(3)
    zeros = jnp.zeros_like(lo)
    S0 = _pack_words([lo, hi, zeros, zeros])            # (8, 16, L)
    # add the partition axis: (8, 16, P, L); per-partition key masks
    S0 = jnp.broadcast_to(S0[:, :, None, :], (8, 16, P, L))
    km = jnp.transpose(masks, (1, 2, 3, 0))[:, :, :, :, None]  # (11,8,16,P,1)
    St = S0 ^ km[0]
    for r in range(1, 10):
        St = _mix_columns(_shift_rows(_sub_bytes(St))) ^ km[r]
    St = _shift_rows(_sub_bytes(St)) ^ km[10]
    St = St ^ S0  # MMO feed-forward
    # unpack word 0 for each partition: (8, 4, P, L) -> per-partition u32
    blk = St[:, 0:4, :, :]                              # (8, 4, P, L)
    arr = jnp.transpose(blk, (2, 3, 1, 0)).reshape(P, -1, 32)
    out = transpose32(arr.reshape(-1, 32)).reshape(P, pad)
    return (out[:, :n] & jnp.uint32(chunk_mask)).reshape(P, T, S)



@functools.partial(jax.jit, static_argnames=("k", "block"))
def _hintgen_gather(db4, table, skip, k: int, block: int = 1024):
    """Hint generation as flat row gathers XOR-reduced over chunks:
    db4 (S, P, C*k, 128); table (P, T, S) u32 offsets; skip (P, T, S) bool
    -> (P, T, k*128) u32, the contract of xor_scan_parts + a reshape.

    The hint axis runs in blocks of `block` hints under lax.map, and each
    block is ONE gather of all its (chunk, hint) rows reduced over the
    chunk axis. Unlike the lax.scan form, the parity accumulator is never
    rewritten per chunk: every parity row is written once."""
    S, P, _, L = db4.shape
    T = table.shape[1]
    block = min(block, T)
    nb = -(-T // block)
    pad = nb * block - T
    off = jnp.pad(table.astype(jnp.int32), ((0, 0), (0, pad), (0, 0)))
    skp = jnp.pad(skip, ((0, 0), (0, pad), (0, 0)), constant_values=True)
    off = off.reshape(P, nb, block, S).transpose(1, 3, 0, 2)  # (nb, S, P, b)
    skp = skp.reshape(P, nb, block, S).transpose(1, 3, 0, 2)

    def one(args):
        o, sk = args                                        # (S, P, block)
        rows = (o[..., None] * k
                + jnp.arange(k, dtype=jnp.int32)).reshape(S, P, block * k)
        g = jnp.take_along_axis(db4, rows[..., None], axis=2)  # (S,P,b*k,L)
        g = jnp.where(jnp.repeat(sk, k, axis=2)[..., None], jnp.uint32(0), g)
        return jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_xor, (0,))

    out = jax.lax.map(one, (off, skp))                     # (nb, P, b*k, L)
    out = out.reshape(nb, P, block, k * L).transpose(1, 0, 2, 3)
    return out.reshape(P, nb * block, k * L)[:, :T]




def _timed(fn, reps):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, ts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from pacmann import native_lib
    from pacmann.io.synth import synth_raw_device
    from pacmann.ops import aes
    from pacmann.ops.xor_scan import xor_scan_parts
    from pacmann.pir.device_engine import DevicePianoEngine, _build_skip
    from pacmann.utils.platform import card_name_power, enable_compile_cache

    enable_compile_cache()
    smi = card_name_power()
    dev = jax.devices()[0]
    print(f"# device {dev.platform} {dev.device_kind} | {smi}",
          flush=True)

    n, dim, m = args.n, 128, 32
    raw = synth_raw_device(n, dim + m, seed=0, float_cols=dim, nbr_cols=m)
    eng = DevicePianoEngine(n, 4 * (dim + m), m, raw, 8)
    del raw
    p, P = eng.params, eng.config.partition_num
    S, R, Hp, C, k = (p.set_size, p.max_query_per_chunk,
                      p.primary_hint_num, p.chunk_size, eng.k)
    T = Hp + S * R
    cm = p.chunk_mask
    print(f"# P={P} T={T} S={S} C={C} k={k}", flush=True)
    rng = np.random.default_rng(1)
    keys = [rng.bytes(16) for _ in range(P)]
    masks = jnp.asarray(np.stack([aes.expand_key_planes(kb) for kb in keys]))
    rows = []

    def rec(name, first, ts, **extra):
        r = dict(form=name, first_s=first, min_s=min(ts),
                 median_s=float(np.median(ts)), reps=len(ts), **extra)
        rows.append(r)
        print(json.dumps(r), flush=True)

    # -- PRF tables
    want, first, ts = _timed(
        lambda: _prf_tables_fused(masks, T, S, cm), args.reps)
    rec("prf_dev_fused", first, ts)
    tab_map = jax.jit(lambda mk: jax.lax.map(
        lambda m1: aes._prf_table_on_device(m1, T, S, cm), mk))
    got, first, ts = _timed(lambda: tab_map(masks), args.reps)
    rec("prf_dev_map", first, ts,
        equal=bool(np.array_equal(np.asarray(got), np.asarray(want))))
    del got
    native = native_lib.available()

    def host_tables():
        return jnp.asarray(np.stack([
            native_lib.prf_offset_table(native_lib.expand_key(kb), 0, T, S,
                                        cm) for kb in keys]))
    if native:
        got, first, ts = _timed(host_tables, args.reps)
        rec("prf_host_native_upload", first, ts,
            equal=bool(np.array_equal(np.asarray(got), np.asarray(want))))
        del got
    else:
        print("# native AES-NI library unavailable", flush=True)

    # -- hint scan
    table = want
    skip = _build_skip(P, T, Hp, R, S).reshape(P, T, S)
    gathered = P * T * S * k * 512
    ref = None
    for cps in (1, 2, 4, 31):
        got, first, ts = _timed(
            lambda: xor_scan_parts(eng.db, table, skip, k,
                                   chunks_per_step=cps), args.reps)
        got = np.asarray(got).reshape(P, T, k * 128)
        ref = got if ref is None else ref
        rec(f"scan_c{cps}", first, ts, gathered_bytes=gathered,
            gbps=gathered / min(ts) / 1e9,
            equal=bool(np.array_equal(got, ref)))
        del got
    for block in (256, 1024, 4096):
        got, first, ts = _timed(
            lambda: _hintgen_gather(eng.db, table, skip, k, block=block),
            args.reps)
        rec(f"scan_gather_b{block}", first, ts, gathered_bytes=gathered,
            gbps=gathered / min(ts) / 1e9,
            equal=bool(np.array_equal(np.asarray(got), ref)))
        del got
    stats = dev.memory_stats() or {}
    out = dict(device=dev.device_kind, nvidia_smi=smi,
               peak_bytes=stats.get("peak_bytes_in_use"), rows=rows,
               shape=dict(n=n, P=P, T=T, S=S, C=C, k=k))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/kernel_choice.json", "w") as f:
        json.dump(out, f, indent=1)
    ok = all(r.get("equal", True) for r in rows)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
