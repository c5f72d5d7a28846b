"""Mid-size recall quality gate (VERDICT r2 weak #8).

The unit suite's uniform-data tests gate recall loosely (0.45-0.65) because
uniform high-d data is adversarial for any graph method. This gate runs the
full pipeline on the SIFT-like continuum workload (latent-16 manifold, the
regime the framework is built for) where a healthy build + beam search must
score near-perfect recall — a graph/protocol regression that the loose
canaries can't see (e.g. broken corridor candidates, a prune bug that
drops highway edges, a beam extract-min fault) fails this test.
"""

import numpy as np

from pacmann.graph.beam import PlaintextEngine
from pacmann.graph.build import build_graph
from pacmann.graph.recall import brute_force_knn, compute_recall


def _continuum(n, d, rng, latent=16):
    basis = (rng.standard_normal((latent, d)) / np.sqrt(latent)) \
        .astype(np.float32)
    z = rng.standard_normal((n, latent)).astype(np.float32)
    return (z @ basis
            + 0.02 * rng.standard_normal((n, d)).astype(np.float32))


def test_continuum_recall_gate():
    rng = np.random.default_rng(0)
    n, d, m = 4096, 64, 32
    v = _continuum(n, d, rng)
    graph = build_graph(v, m, rounds=3, seed=0, quality_gate=False)
    Q = 50
    q = v[rng.choice(n, Q, replace=False)] \
        + 0.1 * rng.standard_normal((Q, d)).astype(np.float32)
    gnd = brute_force_knn(v, q, 10)
    ids, _ = PlaintextEngine(v, graph).search(q, 10, 20, 3, seed=1)
    r = compute_recall(gnd, ids, 10)
    # measured 1.00 on healthy builds; 0.93 leaves slack for seed drift
    # while still catching any structural regression
    assert r >= 0.93, r
