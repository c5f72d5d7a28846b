"""Compute kernels (plain XLA): distance, bitsliced AES PRF, XOR parity scans."""

from pacmann.ops.distance import inner_product_xla, l2_distance  # noqa: F401
