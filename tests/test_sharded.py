"""Multi-device sharding tests on the 8-device virtual CPU mesh
(tests/conftest.py): overlap-save tile parallelism (parallel/sharded.py),
its engine integration (DSD2DXD_SHARD_STREAM=1), and file-level
device round-robin in the CLI — the device mappings of the reference's
Rayon file fan-out (reference src/main.rs:279-297; SURVEY.md §2.6, §5
long-context row)."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu.ops.dsm import synth_tone_dsd
from dsd2dxd_tpu.ops.phase import (
    build_chain_plans,
    init_phase_hists,
    make_phase_step,
)
from dsd2dxd_tpu.ops.resample import StepConfig
from dsd2dxd_tpu.parallel.sharded import (
    convert_stream_tiled,
    halo_bytes_for,
    make_sharded_convert,
)


def _mesh_1d(n=8):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("tile",))


def _streaming_oracle(planes, chain, cfg):
    """One whole-stream pass through the phase path (zero history)."""
    step = make_phase_step(
        chain, StepConfig(channels=planes.shape[0],
                          tile_bytes=planes.shape[1],
                          bit_depth=cfg.bit_depth, dither=cfg.dither,
                          level_db=cfg.level_db), jit=False)
    out, peak, _ = step(jnp.asarray(planes),
                        init_phase_hists(build_chain_plans(chain),
                                         planes.shape[0]),
                        jax.random.PRNGKey(0))
    return np.asarray(out), float(peak)


@pytest.mark.parametrize("bit_depth,dither,tol", [
    (32, DitherType.NONE, 1e-4),
    (24, DitherType.NONE, 3),      # f32 summation order only
    (24, DitherType.TPDF, 4),      # different noise streams per mode
    (16, DitherType.TPDF, 4),
])
def test_convert_stream_tiled_matches_streaming(bit_depth, dither, tol):
    mesh = _mesh_1d()
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    ratio = chain_ratio(chain)
    planes = synth_tone_dsd(1000.0, 0.1, 2_822_400, amplitude=0.5,
                            channels=2)
    cfg = StepConfig(channels=2, tile_bytes=0, bit_depth=bit_depth,
                     dither=dither, level_db=-1.0)
    got, peak = convert_stream_tiled(planes, chain, cfg, mesh)
    ref, ref_peak = _streaming_oracle(planes, chain, cfg)
    assert got.shape[0] == int(planes.shape[1] * 8 * ratio)
    # warmup: idle-pad left context vs the streaming zero history
    skip = int(halo_bytes_for(chain) * 8 * ratio) + 1
    n = min(len(got), len(ref))
    if bit_depth == 32:
        err = np.max(np.abs(got[skip:n] - ref[skip:n]))
    else:
        err = np.abs(got[skip:n].astype(np.int64)
                     - ref[skip:n].astype(np.int64)).max()
    assert err <= tol, err
    assert abs(peak - ref_peak) < 1e-3


def test_convert_stream_tiled_deep_chain():
    """A rephasing chain (÷32) through the tile-sharded path."""
    mesh = _mesh_1d()
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 88200)
    ratio = chain_ratio(chain)
    planes = synth_tone_dsd(1000.0, 0.1, 2_822_400, amplitude=0.5,
                            channels=2)
    cfg = StepConfig(channels=2, tile_bytes=0, bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    got, _ = convert_stream_tiled(planes, chain, cfg, mesh)
    ref, _ = _streaming_oracle(planes, chain, cfg)
    skip = int(halo_bytes_for(chain) * 8 * ratio) + 1
    n = min(len(got), len(ref))
    assert np.max(np.abs(got[skip:n] - ref[skip:n])) < 1e-4


@pytest.mark.parametrize("out_hz", [352800, 88200, 96000])
def test_chunked_streaming_matches_one_dispatch(out_hz):
    """convert_stream_tiled_chunked (bounded host memory, VERDICT r2
    weak 4) must produce bit-identical PCM to the one-dispatch
    convert_stream_tiled: every output sample's FIR receptive field sees
    the same bytes in the same slicing order regardless of tile/chunk
    boundaries."""
    from dsd2dxd_tpu.parallel.sharded import convert_stream_tiled_chunked

    mesh = _mesh_1d()
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, out_hz)
    planes = synth_tone_dsd(997.0, 0.25, 2_822_400, amplitude=0.5,
                            channels=2)
    cfg = StepConfig(channels=2, tile_bytes=4096, bit_depth=32,
                     dither=DitherType.NONE, level_db=-0.5)
    ref, ref_peak = convert_stream_tiled(planes, chain, cfg, mesh)

    pos = [0]
    max_req = [0]

    def read(n):
        max_req[0] = max(max_req[0], n)
        if pos[0] >= planes.shape[1]:
            return None
        # ragged chunks: exercise carry across macro boundaries
        take = min(n if pos[0] else n // 2, planes.shape[1] - pos[0])
        out = planes[:, pos[0]:pos[0] + take]
        pos[0] += take
        return out

    got = []
    updates = []
    peak = convert_stream_tiled_chunked(
        read, chain, cfg, mesh, lambda t: got.append(t.copy()),
        progress=updates.append, total_bytes=planes.shape[1])
    got = np.concatenate(got, axis=0)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # peaks are masked to valid output frames on device (finish_tile
    # n_valid), so both tilings measure the same samples exactly
    assert abs(peak - ref_peak) < 1e-6
    # bounded memory: the reader is only ever asked for one macro-chunk
    # of n_dev x the EFFECTIVE tile (cfg.tile_bytes rounded up to the
    # chain unit — 4116 not 4096 for the x160/147 rational family)
    from dsd2dxd_tpu.parallel.sharded import _chain_unit_bytes

    unit = _chain_unit_bytes(chain)
    eff_tile = -(-cfg.tile_bytes // unit) * unit
    assert max_req[0] == 8 * eff_tile
    # real incremental progress, monotone to 100
    pcts = [u.percent for u in updates]
    assert len(pcts) >= 2 and pcts == sorted(pcts)


def test_chunked_streaming_trims_sample_count():
    """max_bits trims trailing padding bits exactly like the streaming
    engine (non-byte-aligned DSF sample counts)."""
    from dsd2dxd_tpu.parallel.sharded import convert_stream_tiled_chunked

    mesh = _mesh_1d()
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    planes = synth_tone_dsd(1000.0, 0.05, 2_822_400, amplitude=0.5,
                            channels=2)
    cfg = StepConfig(channels=2, tile_bytes=4096, bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    max_bits = planes.shape[1] * 8 - 4000
    pos = [0]

    def read(n):
        if pos[0] >= planes.shape[1]:
            return None
        out = planes[:, pos[0]:pos[0] + n]
        pos[0] += out.shape[1]
        return out

    got = []
    convert_stream_tiled_chunked(read, chain, cfg, mesh,
                                 lambda t: got.append(t.copy()),
                                 max_bits=max_bits)
    n = sum(t.shape[0] for t in got)
    assert n == int(max_bits * chain_ratio(chain))


def test_make_sharded_convert_2d_mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("need 8 devices")
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("stream", "tile"))
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    tile_bytes = 2048
    cfg = StepConfig(channels=2, tile_bytes=tile_bytes, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    fn, halo = make_sharded_convert(chain, cfg, mesh)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(2, 4, 2, halo + tile_bytes),
                     dtype=np.uint8)
    keys = jnp.asarray(jax.random.split(jax.random.PRNGKey(0), 8)
                       ).reshape(2, 4, -1)
    ratio = chain_ratio(chain)
    n_keep = int(tile_bytes * 8 * ratio)
    valids = jnp.full((2, 4), n_keep, dtype=jnp.int32)
    out, peak = fn(jnp.asarray(x), keys, valids)
    assert out.shape == (2, 4, n_keep, 2)
    assert np.isfinite(float(peak)) and 0.0 < float(peak) < 2.0


def _write_tone_dsf(path, seconds=0.1):
    from dsd2dxd_tpu.formats.dsf import write_dsf

    planes = synth_tone_dsd(1000.0, seconds, 2_822_400, amplitude=0.5,
                            channels=2)
    write_dsf(path, planes, 2_822_400, lsb_first=True)
    return path


def _read_wav_pcm24(path):
    import struct

    raw = Path(path).read_bytes()
    pos, data = 12, None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
        if cid == b"data":
            data = raw[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
    v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
         | (b[:, 2].astype(np.int32) << 16))
    return np.where(v >= 1 << 23, v - (1 << 24), v).reshape(-1, 2)


def test_engine_tile_sharded_mode(tmp_path, monkeypatch):
    """DSD2DXD_SHARD_STREAM=1 routes a conversion through
    convert_stream_tiled; the written file matches the streaming
    engine's output past the warmup."""
    from dsd2dxd_tpu.pipeline.engine import Converter

    if len(jax.devices()) < 2:
        pytest.skip("need multiple devices")
    src = _write_tone_dsf(tmp_path / "tone.dsf")

    def convert(out_dir):
        out_dir.mkdir(exist_ok=True)
        conv = Converter.from_container(
            bit_depth=24, output=OutputType.WAV, level_db=0.0,
            output_rate=352800, out_dir=out_dir, dither=DitherType.NONE,
            filt=FilterType.EQUIRIPPLE, append_rate=False,
            base_dir=src.parent, input_path=src)
        updates = []
        conv.do_conversion(progress=updates.append)
        assert updates and updates[-1].percent == 100.0
        return _read_wav_pcm24(out_dir / "tone.wav")

    monkeypatch.delenv("DSD2DXD_SHARD_STREAM", raising=False)
    plain = convert(tmp_path / "a")
    monkeypatch.setenv("DSD2DXD_SHARD_STREAM", "1")
    sharded = convert(tmp_path / "b")
    assert plain.shape == sharded.shape
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    skip = int(halo_bytes_for(chain) * 8 * chain_ratio(chain)) + 1
    d = np.abs(plain[skip:].astype(np.int64) - sharded[skip:].astype(np.int64))
    assert d.max() <= 1  # f32 summation order only


def test_engine_tile_sharded_level_check(tmp_path, monkeypatch):
    from dsd2dxd_tpu.pipeline.engine import Converter

    src = _write_tone_dsf(tmp_path / "tone.dsf")
    conv = Converter.new_level_check(
        output_rate=352800, input_path=src, fmt=FmtType.PLANAR,
        endian=Endianness.LSB_FIRST, channels=2, block_size=4096,
        input_rate=DsdRate.DSD64)
    monkeypatch.setenv("DSD2DXD_SHARD_STREAM", "1")
    db = conv.check_level()
    assert -6.5 < db < -4.0


def test_cli_round_robin_multidevice(tmp_path):
    """A multi-file batch converts across devices; outputs are identical
    to the default-device results (the chain is deterministic)."""
    from dsd2dxd_tpu.cli.dsd2dxd import run

    files = [_write_tone_dsf(tmp_path / f"t{i}.dsf") for i in range(3)]
    out_multi = tmp_path / "multi"
    out_multi.mkdir()
    rc = run(["-o", "w", "-d", "X", "-p", str(out_multi),
              *[str(f) for f in files]])
    assert rc == 0
    # multi-input base_dir = parent of the common prefix (main.rs:271-
    # 273), so the common directory's name is kept in the mirrored tree
    d = out_multi / tmp_path.name
    pcms = [_read_wav_pcm24(d / f"t{i}.wav") for i in range(3)]
    # identical inputs -> identical outputs regardless of which device
    # each file landed on
    np.testing.assert_array_equal(pcms[0], pcms[1])
    np.testing.assert_array_equal(pcms[0], pcms[2])


def test_chunked_matches_one_dispatch_dithered_aligned_geometry():
    """With MATCHING tile geometry (total == n_dev x tile_bytes) the
    chunked and one-dispatch paths must be bit-identical even for
    dithered configs: both key tile noise by fold_in(key, absolute tile
    index). (With differing geometry only undithered outputs match —
    the docstrings scope the claim; this pins the aligned case.)"""
    from dsd2dxd_tpu.parallel.sharded import (
        _chain_unit_bytes,
        convert_stream_tiled,
        convert_stream_tiled_chunked,
    )

    mesh = _mesh_1d()
    n_dev = len(mesh.devices.flat)
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    unit = _chain_unit_bytes(chain)
    tile_bytes = -(-4096 // unit) * unit
    planes = synth_tone_dsd(997.0, 0.2, 2_822_400, amplitude=0.5,
                            channels=2)[:, :n_dev * tile_bytes]
    assert planes.shape[1] == n_dev * tile_bytes
    cfg = StepConfig(channels=2, tile_bytes=tile_bytes, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    ref, ref_peak = convert_stream_tiled(planes, chain, cfg, mesh)

    pos = [0]

    def read(n):
        if pos[0] >= planes.shape[1]:
            return None
        take = min(n, planes.shape[1] - pos[0])
        out = planes[:, pos[0]:pos[0] + take]
        pos[0] += take
        return out

    got = []
    peak = convert_stream_tiled_chunked(
        read, chain, cfg, mesh, lambda t: got.append(t.copy()))
    got = np.concatenate(got, axis=0)
    np.testing.assert_array_equal(got, ref)
    assert abs(peak - ref_peak) < 1e-6


def test_chunked_dithered_geometry_mismatch_bounded():
    """The other side of the identity boundary: with DIFFERING tile
    geometry the chunked path keys tile noise by different absolute tile
    indices, so dithered PCM is NOT bit-identical to the one-dispatch
    tiling — but the pre-dither signal is identical, so outputs must
    differ by at most the dither band (TPDF spans 2 LSB; two independent
    draws plus rounding bound the diff at 4). Pins the boundary the
    parallel/sharded.py docstrings document."""
    from dsd2dxd_tpu.parallel.sharded import (
        _chain_unit_bytes,
        convert_stream_tiled,
        convert_stream_tiled_chunked,
    )

    mesh = _mesh_1d()
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    ratio = chain_ratio(chain)
    planes = synth_tone_dsd(997.0, 0.1, 2_822_400, amplitude=0.5,
                            channels=2)
    cfg = StepConfig(channels=2, tile_bytes=0, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    ref, ref_peak = convert_stream_tiled(planes, chain, cfg, mesh)

    pos = [0]

    def read(n):
        if pos[0] >= planes.shape[1]:
            return None
        take = min(n, planes.shape[1] - pos[0])
        out = planes[:, pos[0]:pos[0] + take]
        pos[0] += take
        return out

    # a deliberately different (smaller) tile than one-dispatch's
    # total/n_dev geometry
    cfg_c = StepConfig(channels=2, tile_bytes=_chain_unit_bytes(chain),
                       bit_depth=24, dither=DitherType.TPDF, level_db=0.0)
    got = []
    peak = convert_stream_tiled_chunked(
        read, chain, cfg_c, mesh, lambda t: got.append(t.copy()))
    got = np.concatenate(got, axis=0)
    skip = int(halo_bytes_for(chain) * 8 * ratio) + 1
    n = min(len(got), len(ref))
    err = np.abs(got[skip:n].astype(np.int64)
                 - ref[skip:n].astype(np.int64)).max()
    assert 0 < err <= 4, err  # differs (noise re-keyed), only in dither
    assert abs(peak - ref_peak) < 1e-3


def test_convert_stream_tiled_rational_chain():
    """A 48k-family chain (trailing x160/147 polyphase stage) through
    the tile-sharded path: the tile unit from chain_tile_unit_bits must
    land every tile boundary on a whole rational phase cycle so
    translation invariance holds. Previously untested — only pure ÷2^k
    chains had sharded coverage."""
    mesh = _mesh_1d()
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 96000)
    ratio = chain_ratio(chain)
    planes = synth_tone_dsd(1000.0, 0.1, 2_822_400, amplitude=0.5,
                            channels=2)
    cfg = StepConfig(channels=2, tile_bytes=0, bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    got, peak = convert_stream_tiled(planes, chain, cfg, mesh)
    ref, ref_peak = _streaming_oracle(planes, chain, cfg)
    assert got.shape[0] == int(planes.shape[1] * 8 * ratio)
    skip = int(halo_bytes_for(chain) * 8 * ratio) + 1
    n = min(len(got), len(ref))
    assert np.max(np.abs(got[skip:n] - ref[skip:n])) < 1e-4
    assert abs(peak - ref_peak) < 1e-3


@pytest.mark.parametrize("rate,out_hz", [
    (DsdRate.DSD128, 352800),
    (DsdRate.DSD256, 352800),
    (DsdRate.DSD512, 352800),
    (DsdRate.DSD256, 192000),   # 48k family: x160/147 tail per tile
])
def test_chunked_phase_body_matches_streaming(rate, out_hz):
    """convert_stream_tiled_chunked on 4 devices (each tile runs the
    phase body) against one streaming pass, float undithered, past the
    idle-pad warmup: f32 summation order only."""
    from dsd2dxd_tpu.parallel.sharded import (
        _chain_unit_bytes,
        convert_stream_tiled_chunked,
    )

    mesh = _mesh_1d(4)
    chain = get_chain(FilterType.EQUIRIPPLE, rate, out_hz)
    ratio = chain_ratio(chain)
    planes = synth_tone_dsd(1000.0, 0.03, rate.hz, amplitude=0.5,
                            channels=2)
    unit = _chain_unit_bytes(chain)
    cfg = StepConfig(channels=2, tile_bytes=-(-planes.shape[1] // 6 // unit)
                     * unit, bit_depth=32, dither=DitherType.NONE,
                     level_db=0.0)
    pos = [0]

    def read(n):
        if pos[0] >= planes.shape[1]:
            return None
        take = min(n, planes.shape[1] - pos[0])
        out = planes[:, pos[0]:pos[0] + take]
        pos[0] += take
        return out

    got = []
    peak = convert_stream_tiled_chunked(read, chain, cfg, mesh,
                                        lambda t: got.append(t.copy()))
    got = np.concatenate(got, axis=0)
    ref, ref_peak = _streaming_oracle(planes, chain, cfg)
    assert got.shape == ref.shape == (int(planes.shape[1] * 8 * ratio), 2)
    skip = int(halo_bytes_for(chain) * 8 * ratio) + 1
    assert np.max(np.abs(got[skip:] - ref[skip:])) < 1e-4
    assert abs(peak - ref_peak) < 1e-3
