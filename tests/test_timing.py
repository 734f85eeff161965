"""tools/timing.py — the shared device-timing harness. Pinned here:
the timed pass dispatches every tile exactly once, chains state, waits
once on a digest that depends on every output, and both protocols
aggregate the way their consumers assume."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import timing  # noqa: E402


def test_timed_run_dispatches_all_tiles_and_chains_state():
    import jax.numpy as jnp

    digest = timing.make_digest()
    calls = []

    def step(x, state, i):
        calls.append((int(i), int(state)))
        return jnp.asarray(x) * 2.0, jnp.max(jnp.asarray(x)), state + 1

    tiles = [np.full((2, 4), float(i)) for i in range(3)]
    dt = timing.timed_run(step, lambda: 0, tiles, digest)
    assert dt > 0
    # every tile once, in order, with the state threaded through
    assert calls == [(0, 0), (1, 1), (2, 2)]


def test_stage_tiles_shapes_and_prep():
    rng = np.random.default_rng(0)
    seen = []

    def prep(t):
        seen.append(t.shape)
        return t.astype(np.float32)

    tiles = timing.stage_tiles(prep, rng, tile_bytes=64, n_tiles=3)
    assert len(tiles) == 3
    assert seen == [(2, 64)] * 3


def test_protocol_aggregates():
    vals_a = iter([3.0, 1.0, 2.0])
    assert timing.min_of(lambda: next(vals_a), 3) == 1.0
    a = iter([2.0, 4.0, 6.0])
    b = iter([1.0, 1.0, 1.0])
    ta, tb, med = timing.interleaved_pairs(
        lambda: next(a), lambda: next(b), 3)
    assert ta == [2.0, 4.0, 6.0] and tb == [1.0] * 3
    assert med == 4.0  # median of per-pair ratios, not ratio of medians
    assert timing.xrt(10.0, 2.0) == 5.0
