"""Backend routing and the persistent compile cache.

Every branch of the program that depends on the machine routes on ONE
value, backend(): "gpu" (the accelerator: device-resident offline phase,
device-synthesized data) or "cpu" (tests and rehearsals: host AES-NI
tables, NumPy/XLA-CPU twins). Any other platform is an error, never a
silent default.
"""

from __future__ import annotations

import os

import jax

BACKENDS = ("gpu", "cpu")

# fixed path inside the checkout (listed in .gitignore): the cache key
# includes the directory, so a path that moves never hits
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def backend() -> str:
    """"gpu" or "cpu", from jax.default_backend(); raises on anything else."""
    b = jax.default_backend()
    if b not in BACKENDS:
        raise RuntimeError(
            f"unsupported JAX backend {b!r}: this program runs on an NVIDIA "
            f"GPU ('gpu') or, for tests, the CPU ('cpu')")
    return b


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    $JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself; no other path
    is set in code), else `.jax_cache` at the root of the checkout."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit`), or "" where there is no nvidia-smi. Every
    timing is recorded beside this line: a card set below its top power
    limit runs slower under load."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except FileNotFoundError:
        return ""
    return out.strip()
