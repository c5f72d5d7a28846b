"""Cluster baseline: k-means quality + nearest-centroid search recall
(cluster-search.py:86-217 behavior on synthetic clustered data)."""

import numpy as np

from pacmann.graph.cluster import ClusterSearcher, kmeans
from pacmann.graph.recall import brute_force_knn, compute_recall


def _clustered_data(rng, n_clusters=16, per=128, d=8):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 10
    pts = (centers[:, None, :]
           + rng.standard_normal((n_clusters, per, d)).astype(np.float32))
    return pts.reshape(-1, d), centers


def test_kmeans_recovers_clusters():
    rng = np.random.default_rng(0)
    vectors, centers = _clustered_data(rng)
    cents, labels = kmeans(vectors, 16, n_iter=15, seed=1)
    # every true cluster should map to exactly one learned centroid
    true = np.repeat(np.arange(16), 128)
    agree = 0
    for c in range(16):
        lab = labels[true == c]
        agree += np.max(np.bincount(lab, minlength=16))
    assert agree / len(labels) > 0.95


def test_cluster_search_recall_on_clustered_data():
    rng = np.random.default_rng(1)
    vectors, _ = _clustered_data(rng)
    queries = vectors[rng.choice(len(vectors), 32, replace=False)] \
        + rng.standard_normal((32, vectors.shape[1])).astype(np.float32) * 0.05
    searcher = ClusterSearcher(vectors, 16, n_iter=15, seed=2)
    ids = searcher.search(queries, 10)
    gnd = brute_force_knn(vectors, queries, 10)
    recall = compute_recall(gnd, ids, 10)
    # in-cluster brute force is near-exact when clusters are well separated
    assert recall > 0.9, recall
