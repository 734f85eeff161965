"""Shared device-timing harness for bench.py.

Two protocols:

- ``min_of``: min-of-N (absolute throughput — the best run is the one
  least disturbed by other work on the host);
- ``interleaved_pairs``: alternating A,B reps with the median of
  per-pair ratios (the protocol for comparing two variants on a host
  whose speed wanders).

The timed pass itself dispatches every staged tile (streaming state
chains them on device), folds each output into a tiny digest, and
waits once with ``block_until_ready`` on the stacked digests, which
depend on every output sample.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable


def make_digest():
    """Jitted (sum, max) reduction — tiny to fetch, depends on every
    element of the tile output."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda p: jnp.stack(
        [jnp.sum(p).astype(jnp.float32), jnp.max(p).astype(jnp.float32)]))


def stage_tiles(prep, rng, tile_bytes: int, n_tiles: int = 6,
                channels: int = 2):
    """Synthesize random DSD byte tiles, run the step's host-side prep,
    upload them, and block until everything is resident."""
    import jax

    tiles = [jax.device_put(prep(
        rng.integers(0, 256, size=(channels, tile_bytes), dtype="uint8")))
        for _ in range(n_tiles)]
    jax.block_until_ready(tiles)
    return tiles


def timed_run(step, make_state, tiles, digest, rounds: int = 1) -> float:
    """One timed pass over the staged tiles (looped `rounds` times,
    state chaining across rounds — inputs are never donated, only the
    state is, so re-dispatching the same staged tiles is free extra
    device work with zero extra staging). See module docstring for why
    the single end sync rides the stacked digests."""
    import jax
    import jax.numpy as jnp

    state = make_state()
    t0 = time.perf_counter()
    ds = []
    for r in range(rounds):
        for i, xt in enumerate(tiles):
            out, _peak, state = step(xt, state, r * len(tiles) + i)
            ds.append(digest(out))
    jax.block_until_ready(jnp.stack(ds).sum(axis=0))
    return time.perf_counter() - t0


def min_of(fn: Callable[[], float], n: int = 3) -> float:
    return min(fn() for _ in range(n))


def interleaved_pairs(fa: Callable[[], float], fb: Callable[[], float],
                      pairs: int):
    """Alternate A,B and return (ta_list, tb_list, median per-pair
    ratio ta/tb). Callers warm both arms first, so that compilation
    stays out of the pairs."""
    ta, tb = [], []
    for _ in range(pairs):
        ta.append(fa())
        tb.append(fb())
    ratios = [a / b for a, b in zip(ta, tb)]
    return ta, tb, statistics.median(ratios)


def xrt(audio_seconds: float, wall: float) -> float:
    return audio_seconds / wall
