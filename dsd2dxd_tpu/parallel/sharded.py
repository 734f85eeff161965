"""Multi-device scaling: overlap-save tile parallelism + stream batching.

The reference scales with a CPU thread pool, one file per thread
(reference src/main.rs:148-163, 279-297). The device equivalents
(SURVEY.md §2.6, §5 "long-context" row):

- **stream parallelism (dp)**: a batch of independent streams (files)
  sharded across devices — no collectives;
- **tile parallelism (sp)**: ONE stream split into overlap-save tiles
  with (effective taps - 1) input halos; because the whole chain is FIR
  (no IIR state), tiles are independent and the sequential stream scan
  becomes pure data parallelism over the mesh.

Both are expressed with `jax.sharding.Mesh` + `shard_map`; peaks combine
with `jax.lax.pmax` over the mesh axes (the only cross-device
communication in the system — a scalar).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from dsd2dxd_tpu.filters.design import Stage, chain_ratio
from dsd2dxd_tpu.ops.phase import (
    build_chain_coefs,
    build_chain_plans,
    chain_tile_unit_bits,
    finish_tile,
    init_phase_hists,
    run_chain_phase,
    unpack_bits_phase,
)
from dsd2dxd_tpu.ops.resample import StepConfig, stage_history_len


def chain_halo_bits(chain: Sequence[Stage]) -> int:
    """Input-domain context (bits) that fully warms every stage of the
    cascade: sum of each stage's history mapped back through the
    cumulative decimation of the stages before it."""
    halo = 0
    cum = 1.0  # input samples per stage-input sample
    for s in chain:
        halo += math.ceil(stage_history_len(s) * cum)
        cum *= s.M / s.L
    return halo


def halo_bytes_for(chain: Sequence[Stage]) -> int:
    """Halo rounded up to whole bytes and to the phase-chain tile unit."""
    unit = chain_tile_unit_bits(build_chain_plans(chain))
    bits = chain_halo_bits(chain)
    return (-(-bits // unit)) * unit // 8


def _tile_chain_fn(chain, cfg: StepConfig):
    """Per-tile function: (C, halo+tile bytes) -> ((n_out, C), peak).

    Processes halo+tile through the phase-major cascade with zero initial
    history and keeps only the outputs belonging to the tile —
    translation invariance of the FIR cascade makes them equal to the
    streaming outputs. The cascade body and epilogue are ops/phase.py's
    own (run_chain_phase / finish_tile), so this path cannot drift from
    the streaming step."""
    ratio = chain_ratio(chain)
    dtype = jnp.dtype(cfg.dtype)
    plans = build_chain_plans(chain)
    coefs, n_terms = build_chain_coefs(plans, dtype)
    n_keep = int(cfg.tile_bytes * 8 * ratio)
    gain = 10.0 ** (cfg.level_db / 20.0)

    def fn(x_u8, key, n_valid=None):
        x = unpack_bits_phase(x_u8, dtype=dtype)
        zero_hists = init_phase_hists(plans, x.shape[0], dtype=dtype)
        x, _ = run_chain_phase(x, zero_hists, plans, coefs, n_terms)
        x = x[:, x.shape[1] - n_keep:]
        return finish_tile(x, cfg, key, gain, n_valid=n_valid)

    return fn


def make_sharded_convert(chain, cfg: StepConfig, mesh: Mesh,
                         stream_axis: str = "stream",
                         tile_axis: str = "tile"):
    """Build a jitted 2D-sharded converter over a ('stream', 'tile') mesh.

    Input:  (B, T, C, halo_bytes + tile_bytes) uint8 — B streams split
            into T overlap-save tiles each, sharded P(stream, tile) —
            plus per-tile PRNG keys (B, T, 2) and per-tile valid-output
            counts (B, T) int32 (frames of each tile that are real
            signal; trailing idle-pad FIR ringing past that count is
            masked out of the peak, same as every 1D path).
    Output: (B, T, n_out, C) PCM sharded the same way, plus the global
            peak (pmax over both mesh axes).
    """
    halo = halo_bytes_for(chain)
    tile_fn = _tile_chain_fn(chain, cfg)

    def shard_fn(x, keys, valids):
        # x: (b_local, t_local, C, halo+tile); vmap the tile fn over both.
        out, peaks = jax.vmap(jax.vmap(tile_fn))(x, keys, valids)
        peak = jnp.max(peaks)
        peak = jax.lax.pmax(jax.lax.pmax(peak, tile_axis), stream_axis)
        return out, peak

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(stream_axis, tile_axis, None, None),
                  P(stream_axis, tile_axis, None),
                  P(stream_axis, tile_axis)),
        out_specs=(P(stream_axis, tile_axis, None, None), P()),
    )
    return jax.jit(mapped), halo


def split_overlap_save(planes: np.ndarray, n_tiles: int, tile_bytes: int,
                       halo_bytes: int) -> np.ndarray:
    """(C, B) stream -> (n_tiles, C, halo+tile) overlap-save tiles.
    The stream is zero-... idle-padded on the left (warmup) and on the
    right up to n_tiles*tile_bytes (callers trim outputs)."""
    c, total = planes.shape
    need = n_tiles * tile_bytes
    if total < need:
        pad = np.full((c, need - total), 0x69, dtype=np.uint8)
        planes = np.concatenate([planes, pad], axis=1)
    lead = np.full((c, halo_bytes), 0x69, dtype=np.uint8)
    padded = np.concatenate([lead, planes], axis=1)
    tiles = [padded[:, t * tile_bytes:t * tile_bytes + halo_bytes + tile_bytes]
             for t in range(n_tiles)]
    return np.stack(tiles)


def convert_stream_tiled(planes: np.ndarray, chain, cfg: StepConfig,
                         mesh: Mesh, key=None):
    """Convert one whole stream by sharding its overlap-save tiles over a
    1D mesh. Returns ((n_out, C) np.ndarray, peak).

    Note: unlike the streaming engine (zero initial filter state), the
    left warmup here is idle-pattern padding; outputs match the streaming
    path everywhere past the first halo's worth of samples.
    """
    assert len(mesh.axis_names) == 1, "convert_stream_tiled wants a 1D mesh"
    axis = mesh.axis_names[0]
    if key is None:
        key = jax.random.PRNGKey(0x5D5D)
    n_dev = math.prod(mesh.devices.shape)
    c, total = planes.shape
    unit = _chain_unit_bytes(chain)
    tile_bytes = -(-total // (n_dev * unit)) * unit
    halo = halo_bytes_for(chain)
    tiles = split_overlap_save(planes, n_dev, tile_bytes, halo)
    # fold_in(key, absolute tile index): the SAME derivation the chunked
    # variant uses, so when the tile geometry matches (total bytes ==
    # n_tiles x cfg.tile_bytes) the two paths produce bit-identical PCM
    # even for dithered configs (pinned in tests/test_sharded.py).
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_dev))
    sub_cfg = dataclasses.replace(cfg, channels=c, tile_bytes=tile_bytes)
    tile_fn = _tile_chain_fn(chain, sub_cfg)

    def shard_fn(x, k, v):
        out, peaks = jax.vmap(tile_fn)(x, k, v)
        return out, jax.lax.pmax(jnp.max(peaks), axis)

    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None, None), P()),
    ))
    ratio = chain_ratio(chain)
    n_valid = int(total * 8 * ratio)
    n_keep = int(tile_bytes * 8 * ratio)
    # per-tile valid-output counts: trailing pad ringing stays out of
    # the reported peak (finish_tile mask)
    valids = jnp.clip(n_valid - jnp.arange(n_dev) * n_keep, 0, n_keep
                      ).astype(jnp.int32)
    out, peak = fn(jnp.asarray(tiles), keys, valids)
    out = np.asarray(out).reshape(-1, c)
    return out[:n_valid], float(peak)


def _chain_unit_bytes(chain) -> int:
    return math.lcm(8, chain_tile_unit_bits(build_chain_plans(chain))) // 8


def convert_stream_tiled_chunked(read, chain, cfg: StepConfig, mesh: Mesh,
                                 sink, key=None, cancel=None, progress=None,
                                 total_bytes=None, max_bits=None):
    """Streaming variant of `convert_stream_tiled`: bounded host memory.

    Instead of staging the whole stream, reads
    macro-chunks of n_devices x cfg.tile_bytes, splits each into
    overlap-save tiles carried across chunk boundaries (the halo is the
    REAL previous bytes, so undithered outputs match the one-dispatch
    version everywhere past the very first halo; dithered outputs match
    when the tile geometry does — same tile_bytes — since both paths
    key tile noise by fold_in(key, absolute tile index)), and dispatches
    ONE jitted
    shard_map per chunk — fixed shapes, so the compile is reused for the
    whole stream (the old path recompiled per file length). Host RSS is
    O(n_devices x tile).

    ``read(n)`` returns (C, m<=n) uint8 or None at EOF; ``sink`` receives
    (frames, C) PCM in order. Returns the stream peak (linear).
    Noise: tile t of chunk m uses fold_in(key, global tile index) — per
    -tile decorrelation matching the streaming engine's discipline.
    """
    from jax.sharding import NamedSharding

    assert len(mesh.axis_names) == 1
    axis = mesh.axis_names[0]
    if key is None:
        key = jax.random.PRNGKey(0x5D5D)
    devices = list(mesh.devices.flat)
    n_dev = len(devices)
    c = cfg.channels
    unit = _chain_unit_bytes(chain)
    tile_bytes = max(unit, -(-cfg.tile_bytes // unit) * unit)
    halo = halo_bytes_for(chain)
    sub_cfg = dataclasses.replace(cfg, tile_bytes=tile_bytes)
    tile_fn = _tile_chain_fn(chain, sub_cfg)

    def shard_fn(x, k, v):
        out, peaks = jax.vmap(tile_fn)(x, k, v)
        return out, jax.lax.pmax(jnp.max(peaks), axis)

    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None, None), P()),
    ))
    macro = n_dev * tile_bytes
    tile_sharding = NamedSharding(mesh, P(axis, None, None))
    key_sharding = NamedSharding(mesh, P(axis, None))
    valid_sharding = NamedSharding(mesh, P(axis))
    n_keep = int(tile_bytes * 8 * chain_ratio(chain))

    def upload(tiles):
        # one put per device; the global array is assembled without
        # further copies
        shards = [jax.device_put(tiles[i:i + 1], devices[i])
                  for i in range(n_dev)]
        return jax.make_array_from_single_device_arrays(
            tiles.shape, tile_sharding, shards)

    ratio = chain_ratio(chain)
    carry = np.full((c, halo), 0x69, dtype=np.uint8)  # idle warmup
    consumed = 0
    valid_bits = 0
    emitted = 0
    peak = 0.0
    t_global = 0
    pending = None  # one-deep dispatch pipeline

    def drain(pending_item, peak):
        out, pk, n_valid = pending_item
        if n_valid > 0 and sink is not None:
            sink(np.asarray(out).reshape(-1, c)[:n_valid])
        return max(peak, float(pk))

    while True:
        if cancel is not None and cancel():
            from dsd2dxd_tpu.utils.errors import CancelledError

            raise CancelledError("Conversion canceled")
        # fill one macro-chunk, tolerating short (non-EOF) reads
        parts = []
        got = 0
        eof = False
        while got < macro:
            b = read(macro - got)
            if b is None:
                eof = True
                break
            parts.append(b)
            got += b.shape[1]
        if got == 0:
            break
        chunk = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        consumed += got
        valid_bits += got * 8
        if max_bits is not None:
            # trailing padding bits of a non-byte-aligned sample count
            # are never converted as signal (engine discipline)
            valid_bits = min(valid_bits, max_bits)
        if got < macro:
            pad = np.full((c, macro - got), 0x69, dtype=np.uint8)
            chunk = np.concatenate([chunk, pad], axis=1)
        padded = np.concatenate([carry, chunk], axis=1)
        tiles = np.stack([
            padded[:, t * tile_bytes:t * tile_bytes + halo + tile_bytes]
            for t in range(n_dev)])
        carry = padded[:, macro:]
        n_total = int(valid_bits * ratio)
        n_valid, emitted = n_total - emitted, n_total
        keys = jax.device_put(
            jax.vmap(lambda i: jax.random.fold_in(key, i))(
                jnp.arange(t_global, t_global + n_dev)), key_sharding)
        # per-tile masked-peak valid counts (global output frames)
        valids = jax.device_put(
            jnp.clip(n_total - (t_global + jnp.arange(n_dev)) * n_keep,
                     0, n_keep).astype(jnp.int32), valid_sharding)
        t_global += n_dev
        out, pk = fn(upload(tiles), keys, valids)
        if pending is not None:
            peak = drain(pending, peak)
        pending = (out, pk, n_valid)
        if progress is not None and total_bytes:
            from dsd2dxd_tpu.formats.dsd_types import (
                ONE_HUNDRED_PERCENT,
                ProgressUpdate,
            )

            pct = min(100.0 * consumed / total_bytes, ONE_HUNDRED_PERCENT)
            progress(ProgressUpdate(percent=pct))
        if eof:
            break
    if pending is not None:
        peak = drain(pending, peak)
    return peak
