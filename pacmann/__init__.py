"""pacmann — private approximate-nearest-neighbor search on an NVIDIA GPU.

A from-scratch JAX/XLA rebuild of the capabilities of wuwuz/Pacmann
(reference: /root/reference): a constant-degree graph ANN index (Vamana-style
build + batched beam search) composed with PianoPIR, a sublinear single-server
preprocessing PIR scheme, so a client can run k-NN queries over a server-hosted
vector database without revealing which vectors it touches.

Layer map (mirrors reference SURVEY.md §1, re-architected for a device):

  ops/       XLA compute kernels: batched L2 / inner-product distance,
             bitsliced AES-128-MMO PRF, XOR parity scans, hint generation.
  pir/       PianoPIR core protocol + batch-PIR scheduler + fused device engine.
  graph/     Beam-search frontend and in-house Vamana-style graph construction.
  private/   PIR-backed vertex oracle + end-to-end private search driver.
  parallel/  Device-mesh sharding (XOR all-reduce, partition sharding).
  io/        bvecs/fvecs/ivecs/npy/txt loaders, report writer, synthetic
             data from a seed.
  utils/     backend routing ("gpu" | "cpu") and the compile cache.
"""

__version__ = "0.1.0"

from pacmann import ops, pir, graph, private, parallel, io, utils  # noqa: F401
