"""Batched, fully-jitted beam search — the device form of the frontier.

The reference's per-query heap + hash-map traversal (graphann/search.go:
114-234) is data-dependent control flow that cannot map onto XLA. The device
engine replaces it with fixed-shape state per query, identical best-first
semantics:

  * visited table: a fixed-capacity slot array (parallel + maxStep*parallel*m
    slots); each step writes its parallel*m fetched candidates into its own
    slot range, with rejected candidates masked to id=-1 / dist=+inf.
  * frontier pop  = masked arg-min over unexplored visited slots (the heap's
    extract-min), `parallel` times per step.
  * dedup         = candidate-vs-visited id match matrix + first-occurrence
    mask within the batch (the knownVertices map).
  * empty frontier / benchmarking -> random candidate ids (search.go:155-159),
    keeping the oblivious fixed access pattern.
  * all-zero-neighbor candidates are skipped (failed PIR fetches,
    search.go:192-199).

The whole maxStep loop is a lax.scan, vmapped over concurrent queries, so one
jit compilation serves the entire query batch; distances are matrix products.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pacmann.ops.distance import l2_distance_xla

NEG_ID = jnp.int32(-1)
INF = jnp.float32(np.inf)


def _pop_parallel(dist, explored, parallel):
    """Extract-min `parallel` times; returns slot indices + validity mask.

    One top_k replaces the former sequential argmin+mask loop (the fused
    path's form, fused_search._beam_pop): lax.top_k is stable, so equal
    distances pop in ascending slot order — exactly the order the
    argmin-then-mask loop produced (argmin returns the first minimum).
    """
    masked = jnp.where(explored, INF, dist)
    neg, idx = jax.lax.top_k(-masked, parallel)
    valid = neg > -INF
    return jnp.where(valid, idx, 0), valid


def _first_occurrence_mask(ids):
    """ids (B,) -> mask of first occurrences (the sequential dedup order)."""
    B = ids.shape[0]
    eq = ids[:, None] == ids[None, :]
    lower = jnp.tril(jnp.ones((B, B), bool), k=-1)
    return ~jnp.any(eq & lower, axis=1)


def make_search_step(fetch_fn, n, m, parallel, benchmarking=False):
    """Build one scan step. fetch_fn(ids (B,)) -> (vecs (B,d), nbrs (B,m)).

    State: dict of per-query arrays (ids, dist, nbrs, explored, reach).
    """
    B = parallel * m

    def step_fn(state, inp):
        step_idx, key = inp
        ids, dist, nbrs, explored, reach = (
            state["ids"], state["dist"], state["nbrs"],
            state["explored"], state["reach"],
        )
        query = state["query"]

        slots, valid = _pop_parallel(dist, explored, parallel)
        # mark popped slots explored; invalid pops alias slot 0, so use a
        # commutative scatter-max (True only where the pop was real)
        explored = explored.at[slots].max(valid)
        # the expanded-vertex corridor: emitted as scan ys so callers can
        # reuse the traversal's waypoints (graph-build candidate generation)
        popped_ids = jnp.where(valid, ids[slots], NEG_ID)

        rand_ids = jax.random.randint(key, (parallel, m), 0, n, dtype=jnp.int32)
        popped_nbrs = nbrs[slots]                       # (parallel, m)
        use_rand = benchmarking | ~valid[:, None]
        batch = jnp.where(use_rand, rand_ids, popped_nbrs).reshape(B)
        batch = jnp.clip(batch, 0, n - 1)

        vecs, cand_nbrs = fetch_fn(batch)

        if benchmarking:
            return state, popped_ids

        cdist = l2_distance_xla(query[None, :], vecs)[0]         # (B,)
        known = jnp.any(batch[:, None] == ids[None, :], axis=1)  # vs visited
        firstocc = _first_occurrence_mask(batch)
        nonzero = jnp.any(cand_nbrs != 0, axis=1)
        accept = ~known & firstocc & nonzero

        base = parallel + step_idx * B
        write = base + jnp.arange(B, dtype=jnp.int32)
        ids = ids.at[write].set(jnp.where(accept, batch, NEG_ID))
        dist = dist.at[write].set(jnp.where(accept, cdist, INF))
        nbrs = nbrs.at[write].set(
            jnp.where(accept[:, None], cand_nbrs, 0)
        )
        explored = explored.at[write].set(~accept)
        reach = reach.at[write].set(jnp.where(accept, step_idx, -1))

        state = dict(state, ids=ids, dist=dist, nbrs=nbrs,
                     explored=explored, reach=reach)
        return state, popped_ids

    return step_fn


def _seed_state(query, start_ids, start_vecs, start_nbrs, parallel, cap, m,
                benchmarking=False):
    """Initial visited table: top-`parallel` start vertices (search.go:129-148)."""
    sdist = l2_distance_xla(query[None, :], start_vecs)[0]
    neg, idx = jax.lax.top_k(-sdist, parallel)
    ids0 = start_ids[idx].astype(jnp.int32)
    d0 = -neg
    nb0 = start_nbrs[idx].astype(jnp.int32)

    ids = jnp.full(cap, NEG_ID, jnp.int32)
    dist = jnp.full(cap, INF, jnp.float32)
    nbrs = jnp.zeros((cap, m), jnp.int32)
    explored = jnp.ones(cap, bool)
    reach = jnp.full(cap, -1, jnp.int32)
    if not benchmarking:
        sl = jnp.arange(parallel)
        ids = ids.at[sl].set(ids0)
        dist = dist.at[sl].set(d0)
        nbrs = nbrs.at[sl].set(nb0)
        explored = explored.at[sl].set(False)
        reach = reach.at[sl].set(0)
    return dict(query=query, ids=ids, dist=dist, nbrs=nbrs,
                explored=explored, reach=reach)


@functools.partial(
    jax.jit,
    static_argnames=("n", "m", "k", "max_step", "parallel", "benchmarking"),
)
def _plaintext_search(vectors, graph, start_ids, queries, key, *,
                      n, m, k, max_step, parallel, benchmarking):
    start_vecs = vectors[start_ids]
    start_nbrs = graph[start_ids]
    cap = parallel + max_step * parallel * m

    def fetch(ids):
        return vectors[ids], graph[ids]

    step_fn = make_search_step(fetch, n, m, parallel, benchmarking)

    def one_query(query, qkey):
        state = _seed_state(query, start_ids, start_vecs, start_nbrs,
                            parallel, cap, m, benchmarking)
        keys = jax.random.split(qkey, max_step)
        steps = jnp.arange(max_step, dtype=jnp.int32)
        state, _ = jax.lax.scan(step_fn, state, (steps, keys))
        negd, slot = jax.lax.top_k(-state["dist"], k)
        out_ids = jnp.where(negd > -INF, state["ids"][slot], NEG_ID)
        out_steps = jnp.where(negd > -INF, state["reach"][slot], -1)
        return out_ids, out_steps

    qkeys = jax.random.split(key, queries.shape[0])
    return jax.vmap(one_query)(queries, qkeys)


@functools.partial(
    jax.jit, static_argnames=("n", "m", "max_step", "parallel", "block"))
def search_paths_all(vectors, graph, start_ids, key, *,
                     n, m, max_step, parallel, block):
    """Expansion corridors for EVERY vertex: search each vertex's own vector
    over `graph` and return the ids of the vertices popped (expanded) along
    the way -> (npad, max_step*parallel) i32, -1 where the frontier was
    empty. This is the Vamana/NGT candidate-generation role (SURVEY §7
    step 4): connecting a vertex to its approach corridor is what creates
    the graph's navigation highways. Runs as a lax.scan over vertex blocks,
    vmapped within a block; everything stays on device.
    """
    npad = vectors.shape[0]
    start_vecs = vectors[start_ids]
    start_nbrs = graph[start_ids]
    cap = parallel + max_step * parallel * m

    def fetch(ids):
        return vectors[ids], graph[ids]

    step_fn = make_search_step(fetch, n, m, parallel)

    def one_query(query, qkey):
        state = _seed_state(query, start_ids, start_vecs, start_nbrs,
                            parallel, cap, m)
        keys = jax.random.split(qkey, max_step)
        steps = jnp.arange(max_step, dtype=jnp.int32)
        _, popped = jax.lax.scan(step_fn, state, (steps, keys))
        return popped.reshape(max_step * parallel)

    def body(carry, b):
        # clipped gather instead of dynamic_slice: the last block may run
        # past npad (ceil-div grid); rows clipped to npad-1 produce throwaway
        # duplicates that the caller's [:npad] slice drops.
        ids_b = jnp.clip(b * block + jnp.arange(block, dtype=jnp.int32),
                         0, npad - 1)
        q = vectors[ids_b]
        qkeys = jax.random.split(jax.random.fold_in(key, b), block)
        return carry, jax.vmap(one_query)(q, qkeys)

    nblocks = -(-npad // block)
    _, paths = jax.lax.scan(body, None,
                            jnp.arange(nblocks, dtype=jnp.int32))
    return paths.reshape(nblocks * block, max_step * parallel)[:npad]


class PlaintextEngine:
    """Batched plaintext k-NN search over device-resident vectors + graph."""

    def __init__(self, vectors, graph, start_ids=None):
        self.vectors = jnp.asarray(vectors, jnp.float32)
        self.graph = jnp.asarray(graph, jnp.int32)
        n = self.vectors.shape[0]
        if start_ids is None:
            start_ids = np.arange(int(np.sqrt(n)))  # search.go:51-65
        self.start_ids = jnp.asarray(start_ids, jnp.int32)

    def search(self, queries, k, max_step, parallel, seed=0,
               benchmarking=False):
        n, m = self.graph.shape[0], self.graph.shape[1]
        ids, steps = _plaintext_search(
            self.vectors, self.graph, self.start_ids,
            jnp.asarray(queries, jnp.float32), jax.random.PRNGKey(seed),
            n=n, m=m, k=k, max_step=max_step, parallel=parallel,
            benchmarking=benchmarking,
        )
        return np.asarray(ids), np.asarray(steps)
