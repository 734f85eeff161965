"""Device-side DSD -> PCM DSP: bit unpack, cascaded polyphase FIR
resampling, level scale, dither, requantization, peak tracking.

This is the device-side replacement for the reference engine's inner
conversion loop (reference call site src/main.rs:429 `do_conversion`;
structure inferred in SURVEY.md §3.5). Where the reference streams 4096-
byte blocks through a scalar FIR on the CPU, this module processes
multi-megabyte *tiles* as a handful of XLA ops:

- 1-bit -> ±1 expansion is a vectorized shift/mask (fused by XLA into
  the first convolution's input pipeline);
- each resampling stage is ONE `lax.conv_general_dilated` with
  `lhs_dilation=L` (polyphase interpolation) and `window_strides=M`
  (decimation);
- streaming across tiles is exact: every stage carries a history buffer
  of its last (taps-1)/L input samples through the jitted step (donated,
  so state stays on device);
- dither (counter-based, reproducible via JAX threefry keys), level
  scaling, quantization, and peak reduction are fused into the same
  compiled step.

Everything is shape-static: one compiled executable per (chain, tile
size, bit depth, dither) configuration, reused across all tiles and all
files with the same configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from dsd2dxd_tpu.filters.design import Stage
from dsd2dxd_tpu.formats.dsd_types import DitherType

# ---------------------------------------------------------------------------
# Bit unpack
# ---------------------------------------------------------------------------


def unpack_bits(x_u8: jax.Array, dtype=jnp.float32) -> jax.Array:
    """(C, B) uint8, MSB-first -> (C, 8B) ±1 samples.

    The canonical source layout is MSB-first (formats/source.py normalizes
    LSB-first streams on the host with a byte table).
    """
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (x_u8[:, :, None] >> shifts) & jnp.uint8(1)
    c, b = x_u8.shape
    return (bits.reshape(c, b * 8).astype(dtype) * 2 - 1)


# ---------------------------------------------------------------------------
# One resampling stage (upfirdn semantics, streaming)
# ---------------------------------------------------------------------------


def stage_history_len(stage: Stage) -> int:
    """History carried between tiles, in stage-input samples."""
    return -(-(stage.n_taps - 1) // stage.L)  # ceil((N-1)/L)


def _stage_conv(x: jax.Array, taps: jax.Array, L: int, M: int,
                pad_left: int, n_out: int) -> jax.Array:
    """y[j] = sum_k h[k] * v[j*M - k + pad_left'], v = L-upsampled x.

    Implemented as one grouped 1-D convolution: lhs (C, 1, T) with
    feature_group_count=1 and batch=C; negative left padding trims the
    upsampled stream so tile output j=0 lines up with the global stream
    (see make_step for the alignment math).
    """
    c = x.shape[0]
    n = taps.shape[0]
    lhs = x[:, None, :]
    rhs = jnp.flip(taps)[None, None, :]
    # Right padding chosen so output length is exactly n_out:
    # out_len = floor((dilated + pl + pr - n) / M) + 1
    dilated = (x.shape[1] - 1) * L + 1
    pad_right = (n_out - 1) * M + n - dilated - pad_left
    out = jax.lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(M,),
        padding=[(pad_left, pad_right)],
        lhs_dilation=(L,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=lhs.dtype,
        # true f32 products and accumulation: no TF32 on a GPU (~1e-3
        # relative error, far above the dither floor; see the
        # ops/phase.py einsum note)
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def stage_apply_streaming(x: jax.Array, hist: jax.Array, stage_np: Stage,
                          taps: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Apply one stage to a tile of S input samples with carried history.

    Requires S * L % M == 0. Returns (y of length S*L//M, new history).

    Semantics match scipy.signal.upfirdn over the concatenated stream:
    if the global input is the concatenation of all tiles, the global
    output is the concatenation of all tile outputs, equal to
    upfirdn(h, input, L, M)[:total_S*L//M].
    """
    L, M, n = stage_np.L, stage_np.M, stage_np.n_taps
    h = hist.shape[1]
    s = x.shape[1]
    assert (s * L) % M == 0, (s, L, M)
    n_out = s * L // M
    xin = jnp.concatenate([hist, x], axis=1)
    # Global output index j0 = (tile_start * L) / M needs
    # v[j0*M - k] for k in [0, n); with xin starting at tile_start - h,
    # local upsampled index = j*M - k + h*L. jax conv computes
    # sum_k rhs_flipped... equivalently out[j] = sum_k h[k] v[jM + (n-1) - k - pl]
    # so we need pl = (n-1) - h*L (<= 0: trims warmup).
    pad_left = (n - 1) - h * L
    y = _stage_conv(xin, taps, L, M, pad_left, n_out)
    new_hist = xin[:, xin.shape[1] - h:]
    return y, new_hist


def upfirdn_reference(taps: np.ndarray, x: np.ndarray, L: int, M: int) -> np.ndarray:
    """Host float64 oracle with the exact streaming semantics used on
    device: y[j] = sum_k h[k] v[jM - k], v = zero-stuffed upsample of x
    (leading warmup implicit zeros). Matches scipy.signal.upfirdn
    truncated to len(x)*L//M outputs."""
    from scipy.signal import upfirdn as _upfirdn

    full = _upfirdn(taps, x, up=L, down=M, axis=-1)
    n_out = x.shape[-1] * L // M
    return full[..., :n_out]


def chain_reference(chain: Sequence[Stage], planes: np.ndarray) -> np.ndarray:
    """Host float64 oracle for a whole cascade: (C, B) MSB-first DSD
    bytes -> (C, n_out) samples, zero history before the first bit."""
    y = np.unpackbits(np.asarray(planes, dtype=np.uint8),
                      axis=1).astype(np.float64) * 2 - 1
    for s in chain:
        y = upfirdn_reference(s.taps, y, s.L, s.M)
    return y


# ---------------------------------------------------------------------------
# Dither + quantize epilogue
# ---------------------------------------------------------------------------


def _dither_noise(kind: DitherType, key: jax.Array, shape, dtype) -> Optional[jax.Array]:
    """Dither in LSB units (for int paths). TPDF: ±1 LSB triangular
    (standard for audio requantization); rectangular: ±0.5 LSB uniform.
    Reference dither surface: src/main.rs:171-181, README.md:10-12."""
    if kind is DitherType.TPDF:
        u = jax.random.uniform(key, (2, *shape), dtype=dtype)
        return u[0] + u[1] - 1.0
    if kind is DitherType.RECTANGULAR:
        return jax.random.uniform(key, shape, dtype=dtype) - 0.5
    return None


def quantize_int(x: jax.Array, bit_depth: int, dither: Optional[jax.Array]) -> jax.Array:
    """Float (±1 full scale) -> int32 at bit_depth (16/20/24),
    round-half-to-even (jnp.round), clipped. 20-bit values are in [-2^19, 2^19-1] (the container
    pack shifts them into the top of a 24-bit word — containers/pack.py)."""
    scale = float(1 << (bit_depth - 1))
    y = x * scale
    if dither is not None:
        y = y + dither
    y = jnp.clip(jnp.round(y), -scale, scale - 1.0)
    return y.astype(jnp.int32)


def dither_float32(x: jax.Array, key: jax.Array) -> jax.Array:
    """"Dither Float" for 32-bit float output (reference README.md:236,
    Airwindows "Dither Float" lineage): TPDF noise at the per-sample ulp
    so the mantissa truncation decorrelates from the signal. With an f32
    compute path this is a sub-ulp perturbation; it matters when the
    accumulation path carries more precision than the output format."""
    u = jax.random.uniform(key, (2, *x.shape), dtype=x.dtype)
    tpdf = u[0] + u[1] - 1.0
    mag = jnp.maximum(jnp.abs(x), jnp.float32(1e-30)).astype(jnp.float32)
    exp = jnp.floor(jnp.log2(mag))
    ulp = jnp.exp2(exp - 23.0).astype(x.dtype)
    return (x + tpdf * ulp).astype(jnp.float32)


# ---------------------------------------------------------------------------
# The fused per-tile step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of one compiled convert step."""

    channels: int
    tile_bytes: int          # DSD bytes per channel per tile
    bit_depth: int           # 16/20/24 int, 32 float
    dither: DitherType
    level_db: float
    dtype: str = "float32"   # accumulation dtype ("float32"/"float64")

    @property
    def tile_bits(self) -> int:
        return self.tile_bytes * 8


def init_hists(chain: Sequence[Stage], channels: int, dtype=jnp.float32):
    return tuple(
        jnp.zeros((channels, stage_history_len(s)), dtype=dtype) for s in chain
    )


def tile_out_samples(chain: Sequence[Stage], tile_bits: int) -> int:
    n = tile_bits
    for s in chain:
        assert (n * s.L) % s.M == 0, "tile not aligned to chain"
        n = n * s.L // s.M
    return n


def make_step(chain: Sequence[Stage], cfg: StepConfig, jit: bool = True):
    """Build the jitted per-tile function.

    step(x_u8 (C, tile_bytes), hists, key) ->
        (pcm, peak, new_hists)

    pcm: (n_out, C) int32 for int depths / float32 for 32-bit output —
    frame-major, ready for the host packers. peak: max |float pcm| in
    this tile (pre-dither, post-level), for dsd_levels parity.
    """
    dtype = jnp.dtype(cfg.dtype)
    taps_const = tuple(jnp.asarray(s.taps, dtype=dtype) for s in chain)
    chain = tuple(chain)
    gain = 10.0 ** (cfg.level_db / 20.0)

    def step(x_u8, hists, key):
        x = unpack_bits(x_u8, dtype=dtype)
        new_hists = []
        for stage, taps in zip(chain, taps_const):
            x, h = stage_apply_streaming(x, hists[len(new_hists)], stage, taps)
            new_hists.append(h)
        if gain != 1.0:
            x = x * dtype.type(gain)
        peak = jnp.max(jnp.abs(x))
        if cfg.bit_depth == 32:
            if cfg.dither is DitherType.FPD:
                out = dither_float32(x.astype(jnp.float32), key)
            else:
                out = x.astype(jnp.float32)
        else:
            noise = _dither_noise(cfg.dither, key, x.shape, x.dtype)
            out = quantize_int(x, cfg.bit_depth, noise)
        return out.T, peak.astype(jnp.float32), tuple(new_hists)

    return jax.jit(step, donate_argnums=(1,)) if jit else step
