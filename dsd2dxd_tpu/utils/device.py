"""Device helpers: the persistent compile cache, the devices a file batch
spreads over, and the mesh for sharding one long stream."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

# One fixed directory inside the checkout: JAX keys its cache entries on
# the program, not the path, but a directory that moves between runs
# never hits.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(env: Mapping[str, str] = os.environ) -> Optional[Path]:
    """Where this program puts JAX's persistent compile cache, or None
    when it configures none: ``JAX_COMPILATION_CACHE_DIR`` set (JAX
    reads it itself) or ``DSD2DXD_COMPILE_CACHE=off``."""
    if env.get("DSD2DXD_COMPILE_CACHE", "").lower() in ("0", "off", "none"):
        return None
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def enable_compile_cache() -> Optional[Path]:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.

    A transcoder CLI is a short-lived process: without this, every
    invocation re-pays the XLA compile of its step before the first tile
    runs. With it, repeat runs at the same (chain, tile, depth, dither)
    config skip straight to execution. Best-effort: an uncreatable dir
    just leaves caching off. Returns the directory it configured.
    """
    cache_dir = compile_cache_dir()
    if cache_dir is None:
        return None
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    # the per-tile steps compile in seconds; cache those too
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or "not available". Runs
    nvidia-smi, never JAX, in the child process."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return r.stdout.strip() or "not available"


def batch_devices() -> list:
    """Devices for file-level data parallelism: the CLI round-robins the
    file batch across them, one pipeline per device — the device analog
    of the reference's Rayon one-file-per-thread fan-out (reference
    src/main.rs:279-297; SURVEY.md §2.6)."""
    import jax

    return list(jax.devices())


def stream_mesh():
    """A 1-device-axis Mesh for sharding ONE stream's overlap-save tiles
    across every device (parallel/sharded.py), or None unless enabled
    with DSD2DXD_SHARD_STREAM=1. Opt-in: file-level DP is the better
    default for batches; tile-sharding wins for a single big file."""
    if os.environ.get("DSD2DXD_SHARD_STREAM") != "1":
        return None
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 2:
        return None
    return Mesh(np.array(devs), ("tile",))
