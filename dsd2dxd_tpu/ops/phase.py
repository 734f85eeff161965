"""Phase-major multirate resampling — the device DSP path.

The naive formulation (one `conv_general_dilated` per stage over a
multi-megasample 1-D stream with a tiny channel count, ops/resample.py)
is kept as the test reference. This module instead uses a layout-first
design that XLA compiles to fused elementwise loops:

**Representation.** A stream x[i] is stored phase-major as a (C, P, K)
array: element i lives at [c, i mod P, i div P]. K (millions) is the
long, contiguous axis; P (1..40) is small. The 1-bit unpack produces
this layout for free: bits (C, 8, B) with bit position as the phase
axis — no interleaving transpose anywhere in the pipeline.

**Stage algebra.** For a stage (taps h, up L, down M) consuming a
P_in-phase stream and producing y[j] = sum_k h[k] v[jM - k] (v the
L-upsampled input): choose P_out = L*P_in / gcd(M, L*P_in). Then for an
output phase rho (j = P_out*kappa + rho), every contributing tap k
(those with k ≡ M*rho mod L) reads input index i = kappa*Di + (M*rho-k)/L
with Di = M*P_out/L — a FIXED input phase r = i mod P_in and a lane
slice of stride s = Di/P_in (s = 1 for every /2 stage). Each stage is
therefore a static set of (coefficient, phase, lane-offset) terms:
pure static-sliced multiply-adds, which XLA fuses into one loop per
stage, with zero dynamic indexing and zero layout changes.

Streaming state is a (C, P_in, H) lane-suffix of each stage's input —
carried through the jitted step exactly like ops/resample.py's conv
path, and verified equivalent to it (and to scipy.upfirdn) in tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from dsd2dxd_tpu.filters.design import Stage
from dsd2dxd_tpu.formats.dsd_types import DitherType
from dsd2dxd_tpu.ops.resample import (
    StepConfig,
    _dither_noise,
    dither_float32,
    quantize_int,
)


@dataclass(frozen=True)
class PhaseTerm:
    coef: float
    r_in: int    # input phase row
    base: int    # lane offset (relative to the tile start; negative = history)


@dataclass(frozen=True)
class PhasePlan:
    """Static slicing plan for one stage in phase-major layout.

    Stages are always stride-1: when the minimal phase decomposition
    would need a lane stride s > 1 (any stage where the cumulative
    decimation exceeds the phase count — deep ÷2^k tails, the ÷7 stage,
    rational stages), the plan instead declares p_in = Δi and the input
    is *rephased* (one reshape+transpose, see `rephase`) — strided
    gathers never appear anywhere in the pipeline.
    """

    L: int
    M: int
    p_in: int
    p_out: int
    lane_stride: int                       # always 1 after rephasing
    terms: tuple[tuple[PhaseTerm, ...], ...]  # per output phase
    hist_lanes: int                        # history H along the lane axis
    rephase: int = 1                       # input phase multiplier applied

    @property
    def delta_i(self) -> int:
        return self.M * self.p_out // self.L


def build_plan(stage: Stage, p_in: int) -> PhasePlan:
    L, M = stage.L, stage.M
    h = np.asarray(stage.taps, dtype=np.float64)
    n = len(h)
    p_out = L * p_in // math.gcd(M, L * p_in)
    delta_i = M * p_out // L
    assert delta_i % p_in == 0
    s = delta_i // p_in
    rephase_factor = 1
    if s > 1:
        # upgrade the input phase count so the stage is stride-1:
        # p_in' = p_in*s gives delta_i' = p_in' (verified identity)
        rephase_factor = s
        p_in = p_in * s
        p_out = L * p_in // math.gcd(M, L * p_in)
        delta_i = M * p_out // L
        assert delta_i == p_in, (delta_i, p_in)
        s = 1
    terms: list[tuple[PhaseTerm, ...]] = []
    min_base = 0
    for rho in range(p_out):
        tl = []
        for k in range(n):
            if (M * rho - k) % L != 0:
                continue
            i_off = (M * rho - k) // L
            r = i_off % p_in
            base = (i_off - r) // p_in
            tl.append(PhaseTerm(float(h[k]), r, base))
            min_base = min(min_base, base)
        terms.append(tuple(tl))
    hist = -min_base
    return PhasePlan(L=L, M=M, p_in=p_in, p_out=p_out, lane_stride=s,
                     terms=tuple(terms), hist_lanes=hist,
                     rephase=rephase_factor)


def build_chain_plans(chain: Sequence[Stage], p0: int = 8) -> tuple[PhasePlan, ...]:
    plans = []
    p = p0
    for stage in chain:
        plan = build_plan(stage, p)
        assert plan.p_in == p * plan.rephase
        plans.append(plan)
        p = plan.p_out
    return tuple(plans)


def tree_sum(contribs):
    """Pairwise tree reduction: f32 rounding error grows ~sqrt(log N)
    instead of ~sqrt(N) — the accumulation invariant that keeps the chain
    below the 24-bit dither floor (CLAUDE.md)."""
    while len(contribs) > 1:
        nxt = [a + b for a, b in zip(contribs[::2], contribs[1::2])]
        if len(contribs) & 1:
            nxt.append(contribs[-1])
        contribs = nxt
    return contribs[0]


def rephase(x: jax.Array, s: int) -> jax.Array:
    """(C, p, K) -> (C, p*s, K/s): stream index i = p*k + r moves to
    [i mod p*s, i div p*s] — new phase = p*(k mod s) + r."""
    if s == 1:
        return x
    c, p, k = x.shape
    assert k % s == 0, (k, s)
    return (x.reshape(c, p, k // s, s)
            .transpose(0, 3, 1, 2)
            .reshape(c, p * s, k // s))


def chain_tile_unit_bits(plans: Sequence[PhasePlan]) -> int:
    """Smallest tile length (input samples = bits) that keeps every
    stage's lane counts integral."""
    unit = 8  # byte alignment
    to_input = Fraction(1)  # input samples per stage-input sample
    for p in plans:
        u_stage = math.lcm(p.p_in, p.delta_i)
        f = u_stage * to_input
        unit = math.lcm(unit, f.numerator)
        to_input *= Fraction(p.M, p.L)
    return unit


def unpack_bits_phase(x_u8: jax.Array, dtype=jnp.float32) -> jax.Array:
    """(C, B) uint8 MSB-first -> (C, 8, B) phase-major ±1 samples.

    Stream index i = 8*byte + pos maps to [c, pos, byte]: exactly the
    P=8 phase-major layout, produced without any transpose.
    """
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8).reshape(1, 8, 1)
    bits = (x_u8[:, None, :] >> shifts) & jnp.uint8(1)
    return bits.astype(dtype) * 2 - 1


def stage_apply_phase(x: jax.Array, hist: jax.Array, plan: PhasePlan,
                      coefs: Sequence[jax.Array]) -> tuple[jax.Array, jax.Array]:
    """One stage on a phase-major tile.

    x: (C, p_in, K_in); hist: (C, p_in, H). Returns
    ((C, p_out, K_out), new hist). coefs[rho] is the jnp coefficient
    vector for plan.terms[rho] (passed in so dtype/device placement is
    decided once by the caller).
    """
    x = rephase(x, plan.rephase)
    c, p_in, k_in = x.shape
    assert p_in == plan.p_in
    H = plan.hist_lanes
    s = plan.lane_stride
    n_in = k_in * p_in
    n_out = n_in * plan.L // plan.M
    k_out = n_out // plan.p_out
    xin = jnp.concatenate([hist, x], axis=2) if H else x
    phase_outs = []
    for rho, terms in enumerate(plan.terms):
        contribs = []
        for t_idx, t in enumerate(terms):
            start = H + t.base
            limit = start + (k_out - 1) * s + 1
            sl = jax.lax.slice(xin, (0, t.r_in, start),
                               (c, t.r_in + 1, limit), (1, 1, s))
            contribs.append(coefs[rho][t_idx] * sl[:, 0, :])
        if not contribs:
            phase_outs.append(jnp.zeros((c, k_out), dtype=x.dtype))
            continue
        phase_outs.append(tree_sum(contribs))
    y = jnp.stack(phase_outs, axis=1) if plan.p_out > 1 else phase_outs[0][:, None, :]
    new_hist = xin[:, :, xin.shape[2] - H:] if H else hist
    return y, new_hist


def plan_window(plan: PhasePlan) -> tuple[int, int]:
    """(base_min, W): the lane-offset window spanned by all terms."""
    bases = [t.base for terms in plan.terms for t in terms]
    lo, hi = min(bases), max(bases)
    return lo, hi - lo + 1


def plan_dense_coefs(plan: PhasePlan, dtype=np.float32) -> np.ndarray:
    """Dense (p_out, p_in, W) coefficient tensor over the (phase, lane
    window) grid — zeros where no tap lands."""
    lo, w = plan_window(plan)
    g = np.zeros((plan.p_out, plan.p_in, w), dtype=dtype)
    for rho, terms in enumerate(plan.terms):
        for t in terms:
            g[rho, t.r_in, t.base - lo] += t.coef
    return g


def split_dense_coefs(g: np.ndarray) -> np.ndarray:
    """(p_out, p_in, W) -> (2, p_out, p_in, W): slice 1 holds each output
    phase's largest-magnitude coefficient, slice 0 all the others.

    The matmul form sums the small taps in one accumulation and adds the
    big tap's product last, so the long f32 accumulation runs on small
    partial sums. For the x160/147 stage this cuts the stage's own f32
    error from ~0.24 to ~0.16 LSB24 RMS (the output's own rounding is
    ~0.14), which keeps the 48k-family chains under the 24-bit TPDF
    floor (tests/test_phase.py)."""
    big = np.zeros_like(g)
    flat = g.reshape(g.shape[0], -1)
    idx = np.argmax(np.abs(flat), axis=1)
    rows = np.arange(g.shape[0])
    big.reshape(g.shape[0], -1)[rows, idx] = flat[rows, idx]
    return np.stack([g - big, big])


def stage_apply_phase_matmul(x: jax.Array, hist: jax.Array, plan: PhasePlan,
                             g: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Matmul form of stage_apply_phase for tap-heavy stages (the rational
    48k quality stage has ~4800 terms: per-term slicing would bloat the
    graph and the compile). W window slices feed ONE dot_general:
    out[c, rho, kappa] = sum_{r,w} g[rho, r, w] * xin[c, r,
    kappa*s + base_min + w]. Work is p_in*W/terms-per-output denser than
    minimal but runs as one library matmul. ``g`` is (p_out, p_in, W), or
    (S, p_out, p_in, W) coefficient slices whose outputs are summed in
    order (split_dense_coefs)."""
    x = rephase(x, plan.rephase)
    c, p_in, k_in = x.shape
    H = plan.hist_lanes
    s = plan.lane_stride
    n_out = k_in * p_in * plan.L // plan.M
    k_out = n_out // plan.p_out
    lo, w_len = plan_window(plan)
    xin = jnp.concatenate([hist, x], axis=2) if H else x
    windows = []
    for w in range(w_len):
        start = H + lo + w
        limit = start + (k_out - 1) * s + 1
        windows.append(jax.lax.slice(xin, (0, 0, start), (c, p_in, limit),
                                     (1, 1, s)))
    xw = jnp.stack(windows, axis=3)  # (C, p_in, K_out, W)
    # Precision.HIGHEST: on a GPU the default precision lets cuBLAS run
    # f32 matmuls in TF32 (10-bit mantissa, ~1e-3 relative error) —
    # three orders of magnitude over the 24-bit dither floor, and CPU
    # tests never see it. HIGHEST keeps true f32 products and
    # accumulation; the stage is a small fraction of chain work.
    gs = g if g.ndim == 4 else g[None]
    z = jnp.einsum("crkw,sprw->scpk", xw, gs,
                   preferred_element_type=xin.dtype,
                   precision=jax.lax.Precision.HIGHEST)
    y = z[0]
    for part in z[1:]:
        y = y + part
    new_hist = xin[:, :, xin.shape[2] - H:] if H else hist
    return y, new_hist


def plan_banded_natural(plan: PhasePlan):
    """Natural-layout band form of an upsampling rational stage.

    The (p_out, p_in, W) dense tensor of `plan_dense_coefs` is only ~6%
    dense for the ×160/147 stage, and feeding it costs two transposes
    (the rephase in, `interleave_phases` out). But the band structure
    makes both free in NATURAL layout: output block p_out*k .. p_out*k +
    p_out-1 reads exactly the consecutive input samples p_in*k - nhist
    .. p_in*k + p_in - 1 (each output phase's taps land on consecutive
    stream offsets by construction — i_off = (M*rho - k)/L steps by 1;
    and max_rho i_off = floor(M*(p_out-1)/L) < p_in whenever L > M). So
    the stage is: free reshape (C, n) -> (C, K, p_in), one history
    concat on the minor axis -> (C, K, U), ONE einsum with the dense
    (p_out, U) band, free reshape back. No transposes, no W-stack.

    Returns (band (p_out, U) f32 ndarray, nhist) or None when the plan
    isn't band-eligible (decimating stage, band wider than one block, or
    a phase with gaps — none of which the 48k-family tail produces).
    """
    p = plan.p_in
    offs_all = []
    for terms in plan.terms:
        offs = sorted(t.base * p + t.r_in for t in terms)
        if any(b - a != 1 for a, b in zip(offs, offs[1:])):
            return None
        offs_all.append(offs)
    omin = min(o[0] for o in offs_all)
    omax = max(o[-1] for o in offs_all)
    nhist = -omin
    if nhist <= 0 or nhist > p or omax >= p or plan.hist_lanes != 1:
        return None
    band = np.zeros((plan.p_out, p + nhist), dtype=np.float32)
    for rho, terms in enumerate(plan.terms):
        for t in terms:
            band[rho, t.base * p + t.r_in + nhist] += t.coef
    return band, nhist


def plan_banded_natural_blocks(band, block: int):
    """Row-blocked view of a `plan_banded_natural` band.

    The (p_out, U) band is ~71% zeros even in natural layout (each
    output phase's taps cover ~Tmax of the U columns, sliding by M/L
    per row), so contracting all U columns for every output wastes
    multiply-adds. Splitting the rows into blocks of `block`
    consecutive output phases shrinks each block's column window to
    ~ceil(block*M/L) + Tmax (~48 vs 164 for the x160/147 stage at
    block=32, i.e. 3.4x fewer MACs), with plain minor-axis slices as
    operands. Returns [(lo, panel (<=block, width) f32), ...]; the
    panel rows are exact slices of the band, so the math per output is
    unchanged (same taps, same f32 accumulation class).
    """
    import numpy as np

    band = np.asarray(band)
    blocks = []
    for b0 in range(0, band.shape[0], block):
        rows = band[b0:b0 + block]
        nz = np.nonzero(rows.any(axis=0))[0]
        lo, hi = int(nz[0]), int(nz[-1])
        blocks.append((lo, rows[:, lo:hi + 1].copy()))
    return blocks


def stage_apply_rational_natural(y: jax.Array, hist: jax.Array,
                                 plan: PhasePlan, band: jax.Array,
                                 nhist: int,
                                 blocks=None) -> tuple[jax.Array, jax.Array]:
    """Banded-natural form of the rational tail (see plan_banded_natural).

    y: (C, n) natural-order float samples; hist: the same (C, p_in, 1)
    phase-major history `stage_apply_phase*` carries (its natural suffix
    is the band's history), so the streaming state is interchangeable.
    With `blocks` (from plan_banded_natural_blocks) the einsum runs per
    row block over that block's column window instead of the full band
    — same taps and accumulation class, ~3.4x fewer MACs.
    Returns ((C, n_out) natural order, new hist).
    """
    c, n = y.shape
    p = plan.p_in
    k = n // p
    yr = y.reshape(c, k, p)
    hflat = hist[:, :, 0][:, -nhist:] if nhist < p else hist[:, :, 0]
    prev = jnp.concatenate([hflat[:, None, :], yr[:, :-1, p - nhist:]],
                           axis=1)
    w = jnp.concatenate([prev, yr], axis=2)  # (C, K, nhist + p_in)
    # HIGHEST: same 24-bit-floor reasoning as the phase-major matmul
    # form above (no TF32)
    if blocks is not None:
        zs = [jnp.einsum("cku,pu->ckp", w[:, :, lo:lo + pan.shape[1]],
                         jnp.asarray(pan),
                         preferred_element_type=y.dtype,
                         precision=jax.lax.Precision.HIGHEST)
              for lo, pan in blocks]
        z = jnp.concatenate(zs, axis=2)
    else:
        z = jnp.einsum("cku,pu->ckp", w, band,
                       preferred_element_type=y.dtype,
                       precision=jax.lax.Precision.HIGHEST)
    new_hist = yr[:, -1, :][:, :, None]
    return z.reshape(c, k * plan.p_out), new_hist


_MATMUL_TERM_THRESHOLD = 192


def interleave_phases(y: jax.Array) -> jax.Array:
    """(C, P, K) phase-major -> (C, P*K) natural order."""
    c, p, k = y.shape
    if p == 1:
        return y[:, 0, :]
    return jnp.transpose(y, (0, 2, 1)).reshape(c, p * k)


def init_phase_hists(plans: Sequence[PhasePlan], channels: int,
                     dtype=jnp.float32):
    return tuple(
        jnp.zeros((channels, p.p_in, p.hist_lanes), dtype=dtype)
        for p in plans
    )


def build_chain_coefs(plans: Sequence[PhasePlan], dtype):
    """Per-stage device coefficient structures + term counts, shared by
    every consumer of the phase path (streaming step, sharded tiles)."""
    n_terms = [sum(len(t) for t in p.terms) for p in plans]
    coefs = tuple(
        (jnp.asarray(split_dense_coefs(plan_dense_coefs(p)), dtype=dtype)
         if n > _MATMUL_TERM_THRESHOLD else
         tuple(jnp.asarray([t.coef for t in terms], dtype=dtype)
               for terms in p.terms))
        for p, n in zip(plans, n_terms)
    )
    return coefs, n_terms


def run_chain_phase(x, hists, plans, coefs, n_terms):
    """The full phase-major cascade on an unpacked (C, 8, K) tile.
    Returns ((C, n_out) natural-order float samples, new hists)."""
    new_hists = []
    for plan, cf, n in zip(plans, coefs, n_terms):
        apply = (stage_apply_phase_matmul
                 if n > _MATMUL_TERM_THRESHOLD else stage_apply_phase)
        x, h = apply(x, hists[len(new_hists)], plan, cf)
        new_hists.append(h)
    return interleave_phases(x), tuple(new_hists)


def finish_tile(x, cfg: StepConfig, key, gain: float, n_valid=None):
    """Shared epilogue: level scale -> peak -> dither -> quantize.
    x: (C, n) float samples. Returns ((n, C) PCM, peak f32).

    ``n_valid`` (traced scalar) masks the peak to the first n_valid
    samples — sharded tiles use it so trailing idle-pad ringing never
    leaks into the reported stream peak."""
    if gain != 1.0:
        x = x * x.dtype.type(gain)
    if n_valid is None:
        peak = jnp.max(jnp.abs(x))
    else:
        ids = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        peak = jnp.max(jnp.abs(x) * (ids < n_valid).astype(x.dtype))
    if cfg.bit_depth == 32:
        if cfg.dither is DitherType.FPD:
            out = dither_float32(x.astype(jnp.float32), key)
        else:
            out = x.astype(jnp.float32)
    else:
        noise = _dither_noise(cfg.dither, key, x.shape, x.dtype)
        out = quantize_int(x, cfg.bit_depth, noise)
    return out.T, peak.astype(jnp.float32)


def make_phase_step(chain: Sequence[Stage], cfg: StepConfig, jit: bool = True):
    """Drop-in equivalent of ops.resample.make_step using the phase-major
    path. Same signature/returns: step(x_u8, hists, key) ->
    (pcm (n_out, C), peak, new_hists)."""
    dtype = jnp.dtype(cfg.dtype)
    plans = build_chain_plans(chain, p0=8)
    unit = chain_tile_unit_bits(plans)
    assert (cfg.tile_bytes * 8) % unit == 0, (
        f"tile of {cfg.tile_bytes * 8} bits not aligned to chain unit {unit}")
    coefs, n_terms = build_chain_coefs(plans, dtype)
    gain = 10.0 ** (cfg.level_db / 20.0)

    def step(x_u8, hists, key):
        x = unpack_bits_phase(x_u8, dtype=dtype)
        x, new_hists = run_chain_phase(x, hists, plans, coefs, n_terms)
        out, peak = finish_tile(x, cfg, key, gain)
        return out, peak, new_hists

    return jax.jit(step, donate_argnums=(1,)) if jit else step
