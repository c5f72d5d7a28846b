"""Graph ANN: Vamana-style build, beam search engines, baselines, recall."""

from pacmann.graph.build import build_graph  # noqa: F401
from pacmann.graph.beam import PlaintextEngine  # noqa: F401
from pacmann.graph.beam_host import BasicGraphOracle, BeamSearcher  # noqa: F401
from pacmann.graph.recall import brute_force_knn, compute_recall  # noqa: F401
