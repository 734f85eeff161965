"""Phase-major resampler tests: plan algebra, equivalence with the
conv-based reference path (itself oracle-verified against scipy), and
the matmul form for tap-heavy stages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsd2dxd_tpu.filters.design import Stage, get_chain
from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    DsdRate,
    FilterType,
    rate_cells,
)
from dsd2dxd_tpu.ops.phase import (
    build_chain_plans,
    build_plan,
    chain_tile_unit_bits,
    init_phase_hists,
    make_phase_step,
    plan_dense_coefs,
    stage_apply_phase,
    stage_apply_phase_matmul,
    unpack_bits_phase,
)
from dsd2dxd_tpu.ops.resample import (
    StepConfig,
    chain_reference,
    init_hists,
    make_step,
    upfirdn_reference,
)


def test_unpack_bits_phase_layout():
    x = jnp.asarray(np.array([[0b10110001, 0b01000000]], dtype=np.uint8))
    got = np.asarray(unpack_bits_phase(x))  # (1, 8, 2)
    # stream index i = 8*byte + pos -> [pos, byte]
    stream = np.array([1, -1, 1, 1, -1, -1, -1, 1,   # byte 0 MSB-first
                       -1, 1, -1, -1, -1, -1, -1, -1], dtype=np.float32)
    np.testing.assert_array_equal(got[0], stream.reshape(2, 8).T)


@pytest.mark.parametrize("L,M,n,p0", [
    (1, 2, 14, 8), (1, 2, 48, 4), (1, 7, 52, 8), (1, 8, 96, 8),
    (5, 21, 60, 8), (10, 21, 44, 8), (20, 21, 64, 8), (1, 2, 30, 1),
])
def test_phase_plan_matches_upfirdn(L, M, n, p0):
    """Phase-major streaming == scipy upfirdn on a phase-major stream."""
    rng = np.random.default_rng(0)
    taps = rng.standard_normal(n)
    stage = Stage(taps=taps, L=L, M=M)
    plan = build_plan(stage, p0)
    # tile must keep lanes integral for in and out
    import math

    unit = math.lcm(plan.p_in, plan.delta_i)
    S = unit * 40
    x = rng.standard_normal((2, S * 3))
    ref = upfirdn_reference(taps, x, L, M)
    coefs = tuple(jnp.asarray([t.coef for t in terms], dtype=jnp.float32)
                  for terms in plan.terms)
    # hist lives in the plan's (possibly rephased) input layout
    hist = jnp.zeros((2, plan.p_in, plan.hist_lanes), dtype=jnp.float32)
    outs = []
    for t in range(3):
        xt = x[:, t * S:(t + 1) * S].reshape(2, -1, p0).transpose(0, 2, 1)
        y, hist = stage_apply_phase(
            jnp.asarray(xt, dtype=jnp.float32), hist, plan, coefs)
        # back to natural order
        y = np.asarray(y).transpose(0, 2, 1).reshape(2, -1)
        outs.append(y)
    got = np.concatenate(outs, axis=1)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, err


def test_matmul_form_matches_sliced_form():
    rng = np.random.default_rng(1)
    taps = rng.standard_normal(598)
    stage = Stage(taps=taps, L=5, M=21)
    plan = build_plan(stage, 8)
    import math

    S = math.lcm(plan.p_in, plan.delta_i) * 24
    x = rng.standard_normal((2, S)).astype(np.float32)
    xt = jnp.asarray(x.reshape(2, -1, 8).transpose(0, 2, 1))
    hist = jnp.zeros((2, plan.p_in, plan.hist_lanes), dtype=jnp.float32)
    coefs = tuple(jnp.asarray([t.coef for t in terms], dtype=jnp.float32)
                  for terms in plan.terms)
    y1, h1 = stage_apply_phase(xt, hist, plan, coefs)
    g = jnp.asarray(plan_dense_coefs(plan))
    y2, h2 = stage_apply_phase_matmul(xt, hist, plan, g)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))


ALL_CONFIGS = rate_cells()  # all 29 (bank, input rate, output rate) cells


def _cell_id(cell):
    filt, rate, out_hz = cell
    return f"{filt.name}-{rate.name}-{out_hz}"


def short_tone(chain, rate, n_out=3000, channels=1):
    """A -6 dBFS 1 kHz DSM tone long enough for ~n_out output frames,
    rounded up to the chain's tile unit."""
    from dsd2dxd_tpu.filters.design import chain_ratio
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    unit = chain_tile_unit_bits(build_chain_plans(chain))
    bits = -(-int(n_out / chain_ratio(chain)) // unit) * unit
    planes = synth_tone_dsd(1000.0, bits / rate.hz, rate.hz, amplitude=0.5,
                            channels=channels)
    assert planes.shape[1] * 8 == bits
    return planes


@pytest.mark.parametrize("filt,rate,out_hz", ALL_CONFIGS,
                         ids=map(_cell_id, ALL_CONFIGS))
def test_phase_step_equals_conv_step(filt, rate, out_hz):
    """Full jitted phase step == conv step, streaming across tiles.
    Compared on the float path: the only difference is f32 accumulation
    ordering (each path is separately bounded against the f64 oracle)."""
    chain = get_chain(filt, rate, out_hz)
    plans = build_chain_plans(chain)
    unit = chain_tile_unit_bits(plans)
    tile_bits = unit * max(1, 150_000 // unit)
    cfg = StepConfig(channels=2, tile_bytes=tile_bits // 8, bit_depth=32,
                     dither=DitherType.NONE, level_db=-1.5)
    s_conv = make_step(chain, cfg)
    s_phase = make_phase_step(chain, cfg)
    h1 = init_hists(chain, 2)
    h2 = init_phase_hists(plans, 2)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(9)
    for t in range(3):
        x = rng.integers(0, 256, size=(2, tile_bits // 8), dtype=np.uint8)
        o1, p1, h1 = s_conv(x, h1, key)
        o2, p2, h2 = s_phase(x, h2, key)
        o1, o2 = np.asarray(o1), np.asarray(o2)
        assert o1.shape == o2.shape
        np.testing.assert_allclose(o1, o2, atol=6e-7, rtol=1e-5)
        assert abs(float(p1) - float(p2)) < 1e-4


@pytest.mark.parametrize("filt,rate,out_hz", ALL_CONFIGS,
                         ids=map(_cell_id, ALL_CONFIGS))
def test_phase_full_chain_f32_error(filt, rate, out_hz):
    """Phase path vs the f64 upfirdn oracle, every cell: f32 summation
    noise stays below the 24-bit TPDF dither floor (RMS sqrt(1/6) LSB)."""
    chain = get_chain(filt, rate, out_hz)
    planes = short_tone(chain, rate)
    y = chain_reference(chain, planes)
    cfg = StepConfig(channels=1, tile_bytes=planes.shape[1], bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    step = make_phase_step(chain, cfg)
    hists = init_phase_hists(build_chain_plans(chain), 1)
    out, peak, _ = step(jnp.asarray(planes), hists, jax.random.PRNGKey(0))
    got = np.asarray(out)[:, 0].astype(np.float64)
    err = got - y[0][:len(got)]
    lsb24 = 2.0 ** -23
    assert np.sqrt(np.mean(err ** 2)) < 0.41 * lsb24
    assert np.abs(err).max() < 4 * lsb24


def _walk_eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _walk_eqns(inner)


@pytest.mark.parametrize("rate,out_hz", [
    (DsdRate.DSD64, 352800),   # plain ÷2^k chain
    (DsdRate.DSD256, 192000),  # 48k family: x160/147 matmul tail
])
def test_every_contraction_asks_for_highest_precision(rate, out_hz):
    """Every dot_general and convolution on the device path (phase step)
    and in the conv reference carries Precision.HIGHEST: on a GPU the
    default lets f32 matmuls run in TF32 (~1e-3 relative error), far
    above the 24-bit dither floor, and the CPU never shows it."""
    chain = get_chain(FilterType.EQUIRIPPLE, rate, out_hz)
    plans = build_chain_plans(chain)
    unit = chain_tile_unit_bits(plans)
    cfg = StepConfig(channels=2, tile_bytes=unit * 4 // 8 or 1,
                     bit_depth=24, dither=DitherType.TPDF, level_db=0.0)
    x = jnp.zeros((2, cfg.tile_bytes), jnp.uint8)
    key = jax.random.PRNGKey(0)
    found = []
    for step, hists in (
            (make_phase_step(chain, cfg, jit=False),
             init_phase_hists(plans, 2)),
            (make_step(chain, cfg, jit=False), init_hists(chain, 2))):
        jaxpr = jax.make_jaxpr(step)(x, hists, key).jaxpr
        for eqn in _walk_eqns(jaxpr):
            if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
                prec = eqn.params["precision"]
                precs = prec if isinstance(prec, tuple) else (prec,)
                assert all(p == jax.lax.Precision.HIGHEST for p in precs), (
                    eqn.primitive.name, prec)
                found.append(eqn.primitive.name)
    assert "conv_general_dilated" in found
    if out_hz % 48000 == 0:
        assert "dot_general" in found


def test_engine_uses_phase_path(tmp_path):
    """Smoke: engine end-to-end through the phase path (1 kHz DSF tone)."""
    from dsd2dxd_tpu.formats.dsd_types import OutputType
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd
    from dsd2dxd_tpu.pipeline.engine import Converter

    src = tmp_path / "tone.dsf"
    planes = synth_tone_dsd(1000.0, 0.25, 2_822_400, amplitude=0.5, channels=2)
    write_dsf(src, planes, 2_822_400, lsb_first=True)
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0, output_rate=96000,
        out_dir=tmp_path, dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=tmp_path, input_path=src)
    conv.do_conversion()
    out = tmp_path / "tone.wav"
    raw = out.read_bytes()
    assert raw[:4] == b"RIFF"
    import struct

    rate = struct.unpack("<I", raw[24:28])[0]
    assert rate == 96000


def test_banded_natural_matches_matmul_streaming():
    """The banded-natural rational tail must be band-eligible for every
    48k-family ×160/147 stage and stay in lockstep with the phase-major
    matmul form across streamed tiles — including the (C, p_in, 1)
    history hand-off the two forms share (states are interchangeable, so
    a step can switch forms without a state migration)."""
    from dsd2dxd_tpu.ops.phase import (
        interleave_phases,
        plan_banded_natural,
        stage_apply_rational_natural,
    )

    # only the E bank serves 48k-family rates (check_filter_choice)
    for rate in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256):
        for out_hz in (96000, 192000, 384000):
            stage = get_chain(FilterType.EQUIRIPPLE, rate, out_hz)[-1]
            assert (stage.L, stage.M) == (160, 147)
            plan = build_plan(stage, p_in=1)
            assert plan_banded_natural(plan) is not None, (rate, out_hz)

    stage = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD256, 192000)[-1]
    plan = build_plan(stage, p_in=1)
    band_np, nhist = plan_banded_natural(plan)
    band = jnp.asarray(band_np)
    g = jnp.asarray(plan_dense_coefs(plan))
    rng = np.random.default_rng(7)
    h_m = jnp.zeros((2, plan.p_in, plan.hist_lanes), dtype=jnp.float32)
    h_n = h_m
    n = plan.p_in * 64
    for _ in range(3):
        y = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
        zm, h_m = stage_apply_phase_matmul(y[:, None, :], h_m, plan, g)
        zn, h_n = stage_apply_rational_natural(y, h_n, plan, band, nhist)
        np.testing.assert_allclose(np.asarray(interleave_phases(zm)),
                                   np.asarray(zn), rtol=2e-5, atol=2e-6)
        # identical state convention: last p_in natural samples
        np.testing.assert_array_equal(np.asarray(h_m), np.asarray(h_n))


def test_banded_natural_blocked_matches_unblocked():
    """Row-blocking the natural band (plan_banded_natural_blocks) must
    be taps-exact: each panel is a slice of the band, so the blocked
    einsum reproduces the unblocked one to f32 summation-order noise,
    and the panels jointly cover every nonzero of the band exactly
    once."""
    from dsd2dxd_tpu.ops.phase import (
        plan_banded_natural,
        plan_banded_natural_blocks,
        stage_apply_rational_natural,
    )

    stage = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD256, 192000)[-1]
    plan = build_plan(stage, p_in=1)
    band_np, nhist = plan_banded_natural(plan)
    for blk in (16, 32, 64):
        blocks_np = plan_banded_natural_blocks(band_np, blk)
        # exact coverage: reassembling the panels rebuilds the band
        rebuilt = np.zeros_like(band_np)
        r0 = 0
        for lo, pan in blocks_np:
            rebuilt[r0:r0 + pan.shape[0], lo:lo + pan.shape[1]] = pan
            r0 += pan.shape[0]
        assert r0 == band_np.shape[0]
        np.testing.assert_array_equal(rebuilt, band_np)

    band = jnp.asarray(band_np)
    blocks = [(lo, jnp.asarray(pan))
              for lo, pan in plan_banded_natural_blocks(band_np, 32)]
    rng = np.random.default_rng(11)
    h_a = jnp.zeros((2, plan.p_in, plan.hist_lanes), dtype=jnp.float32)
    h_b = h_a
    n = plan.p_in * 64
    for _ in range(3):
        y = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
        za, h_a = stage_apply_rational_natural(y, h_a, plan, band, nhist)
        zb, h_b = stage_apply_rational_natural(y, h_b, plan, band, nhist,
                                               blocks=blocks)
        np.testing.assert_allclose(np.asarray(za), np.asarray(zb),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_array_equal(np.asarray(h_a), np.asarray(h_b))
