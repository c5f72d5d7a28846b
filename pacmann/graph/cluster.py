"""Cluster-search baseline (Tiptoe-style) — JAX k-means.

Quality lower-bound baseline, the role of /root/reference/cluster-search.py
(C16): k-means the DB into ~sqrt(n) clusters (cluster-search.py:86-114,
FAISS), answer a query by brute-force scan of its nearest cluster
(:170-198), report recall (:207-217). Here both the Lloyd iterations and the
search are batched distance products.
"""

from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp

from pacmann.ops.distance import l2_distance_xla


import functools


@functools.partial(jax.jit, static_argnames=("n_clusters",))
def _kmeanspp_init(sample, key, n_clusters: int):
    """k-means++ seeding as ONE device program (lax.fori over centers):
    carry the running min-distance, sample the next center D^2-proportionally.
    """
    n = sample.shape[0]
    k0 = jax.random.randint(key, (), 0, n)
    min_d = l2_distance_xla(sample[k0][None, :], sample)[0]
    idxs = jnp.zeros(n_clusters, jnp.int32).at[0].set(k0.astype(jnp.int32))

    def body(i, carry):
        min_d, idxs, key = carry
        key, sub = jax.random.split(key)
        p = min_d / jnp.maximum(jnp.sum(min_d), 1e-30)
        nxt = jax.random.categorical(sub, jnp.log(p + 1e-30))
        d_new = l2_distance_xla(sample[nxt][None, :], sample)[0]
        return (jnp.minimum(min_d, d_new),
                idxs.at[i].set(nxt.astype(jnp.int32)), key)

    min_d, idxs, _ = jax.lax.fori_loop(
        1, n_clusters, body, (min_d, idxs, key))
    return sample[idxs]


def kmeans(vectors: np.ndarray, n_clusters: int, n_iter: int = 10,
           seed: int = 0, block: int = 65536, verbose: bool = False):
    """k-means++-seeded Lloyd iterations: returns (centroids (K, d), labels).

    Each iteration is a blocked (n, K) distance pass + segment-sum update —
    the FAISS Kmeans.train equivalent (cluster-search.py:99-107). Seeding
    runs on a <=65536-point subsample entirely on device.
    """
    rng = np.random.default_rng(seed)
    vectors = np.asarray(vectors, np.float32)
    n, d = vectors.shape
    n_sub = min(n, 65536)
    sub = vectors if n_sub == n else vectors[
        rng.choice(n, n_sub, replace=False)]
    centroids = _kmeanspp_init(
        jnp.asarray(sub), jax.random.PRNGKey(seed), n_clusters)
    vec_dev = jnp.asarray(vectors)

    @jax.jit
    def assign_block(block_vecs, centroids):
        dist = l2_distance_xla(block_vecs, centroids)
        return jnp.argmin(dist, axis=1)

    @jax.jit
    def accumulate(labels, block_vecs, sums, counts):
        # one-hot matmul instead of a colliding .at[labels].add (as in
        # build.py's Lloyd); HIGHEST keeps the sums exact (no TF32)
        onehot = jax.nn.one_hot(labels, sums.shape[0], dtype=jnp.float32)
        sums = sums + jnp.dot(onehot.T, block_vecs,
                              precision=jax.lax.Precision.HIGHEST)
        counts = counts + jnp.sum(onehot, axis=0).astype(jnp.int32)
        return sums, counts

    labels = np.empty(n, np.int32)
    for it in range(n_iter):
        sums = jnp.zeros((n_clusters, d), jnp.float32)
        counts = jnp.zeros(n_clusters, jnp.int32)
        for b0 in range(0, n, block):
            blk = vec_dev[b0 : b0 + block]
            lab = assign_block(blk, centroids)
            labels[b0 : b0 + block] = np.asarray(lab)
            sums, counts = accumulate(lab, blk, sums, counts)
        new_c = sums / jnp.maximum(counts[:, None], 1)
        # keep empty clusters where they were
        centroids = jnp.where(counts[:, None] > 0, new_c, centroids)
        if verbose:
            print(f"kmeans iter {it} done")
    return np.asarray(centroids), labels


@functools.partial(jax.jit, static_argnames=("k",))
def _cluster_scan_device(vectors, centroids, members, queries, *, k: int):
    """Route each query to its nearest centroid and brute-force its
    cluster: one fixed-shape program (members padded to the max cluster
    size), so every query block reuses one compile."""
    cd = l2_distance_xla(queries, centroids)
    nearest = jnp.argmin(cd, axis=1)                 # (Qb,)
    mem = members[nearest]                           # (Qb, cap) i32, -1 pad
    valid = mem >= 0
    vecs = vectors[jnp.where(valid, mem, 0)]         # (Qb, cap, d)
    d2 = jnp.sum((vecs - queries[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    negd, idx = jax.lax.top_k(-d2, k)
    ids = jnp.take_along_axis(mem, idx, axis=1)
    return jnp.where(negd > -jnp.inf, ids, -1)


class ClusterSearcher:
    """Nearest-centroid + in-cluster brute force (cluster-search.py:170-198)."""

    QUERY_BLOCK = 64

    def __init__(self, vectors: np.ndarray, n_clusters: int | None = None,
                 n_iter: int = 10, seed: int = 0, verbose: bool = False):
        self.vectors = np.asarray(vectors, np.float32)
        n = self.vectors.shape[0]
        if n_clusters is None:
            n_clusters = max(int(np.sqrt(n)), 1)  # cluster-search.py:92
        t0 = time.perf_counter()
        self.centroids, self.labels = kmeans(
            self.vectors, n_clusters, n_iter, seed, verbose=verbose)
        self.train_time = time.perf_counter() - t0
        # bucket members per cluster
        order = np.argsort(self.labels, kind="stable")
        self.sorted_ids = order.astype(np.int64)
        self.starts = np.searchsorted(self.labels[order], np.arange(n_clusters))
        self.ends = np.searchsorted(self.labels[order],
                                    np.arange(n_clusters) + 1)
        # fixed-capacity member matrix for the device scan: pad every
        # cluster to the max size (-1 = empty). K * cap i32 is small
        # (~a few x n at sqrt(n) clusters).
        sizes = self.ends - self.starts
        cap = max(int(sizes.max()), 1)
        members = np.full((n_clusters, cap), -1, np.int32)
        for c in range(n_clusters):
            members[c, : sizes[c]] = self.sorted_ids[
                self.starts[c] : self.ends[c]]
        self._members_dev = jnp.asarray(members)
        self._vectors_dev = jnp.asarray(self.vectors)
        self._centroids_dev = jnp.asarray(self.centroids)

    def search(self, queries: np.ndarray, k: int):
        """-> ids (Q, k) int64; -1 padded for undersized clusters.

        Runs entirely on device in fixed-shape blocks of QUERY_BLOCK
        queries (the host scan this replaces cost ~107 ms/query at 1M on
        the 1-vCPU box; the device program is one centroid distance pass +
        one member-row gather + top_k per block)."""
        queries = np.asarray(queries, np.float32)
        Q = queries.shape[0]
        B = min(self.QUERY_BLOCK, max(Q, 1))
        out = np.empty((Q, k), np.int64)
        for b0 in range(0, Q, B):
            qb = queries[b0 : b0 + B]
            if qb.shape[0] < B:  # pad to the compiled shape
                qb = np.concatenate(
                    [qb, np.zeros((B - qb.shape[0], qb.shape[1]),
                                  np.float32)])
            ids = _cluster_scan_device(
                self._vectors_dev, self._centroids_dev, self._members_dev,
                jnp.asarray(qb), k=k)
            out[b0 : b0 + B] = np.asarray(ids)[: Q - b0]
        return out
