"""Engine (Converter) tests: container->WAV end-to-end, raw input path,
level check, output-path building (reference behaviors: src/main.rs
325-393, 429; dsd_levels/main.rs:214-252)."""

import struct
from pathlib import Path

import numpy as np
import pytest

from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu.pipeline.engine import Converter


def _read_wav(path):
    raw = Path(path).read_bytes()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    return fmt, data


def _decode_s24le(data, channels):
    b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
    vals = (b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16))
    vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
    return vals.reshape(-1, channels)


@pytest.fixture(scope="module")
def tone_dsf(tmp_path_factory):
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    path = tmp_path_factory.mktemp("engine") / "tone.dsf"
    planes = synth_tone_dsd(1000.0, 0.5, 2_822_400, amplitude=0.5, channels=2)
    write_dsf(path, planes, 2_822_400, lsb_first=True)
    return path


def test_container_to_wav(tone_dsf, tmp_path):
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0, output_rate=352800,
        out_dir=tmp_path, dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=tone_dsf.parent, input_path=tone_dsf)
    updates = []
    conv.do_conversion(progress=updates.append)
    out = tmp_path / "tone.wav"
    assert conv.output_path() == out
    assert out.exists()
    fmt, data = _read_wav(out)
    tag, ch, rate, _, _, bits = fmt
    assert (tag, ch, rate, bits) == (1, 2, 352800, 24)
    pcm = _decode_s24le(data, 2).astype(np.float64) / 2 ** 23
    # 0.5 s in -> 0.5 s out at 352.8k
    assert abs(len(pcm) - 176400) < 2
    x = pcm[20000:170000, 0]
    n = len(x)
    X = np.fft.rfft(x * np.hanning(n))
    freqs = np.fft.rfftfreq(n, 1 / 352800)
    assert abs(freqs[np.argmax(np.abs(X))] - 1000.0) < 5.0
    rms = np.sqrt(np.mean(x ** 2))
    assert abs(rms * np.sqrt(2) - 0.5) < 0.01
    assert updates and updates[-1].percent == 100.0


def test_progress_monotonic(tone_dsf, tmp_path):
    conv = Converter.from_container(
        bit_depth=16, output=OutputType.WAV, level_db=0.0, output_rate=88200,
        out_dir=tmp_path, dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=tone_dsf.parent, input_path=tone_dsf)
    pcts = []
    conv.do_conversion(progress=lambda u: pcts.append(u.percent))
    assert pcts == sorted(pcts)
    assert pcts[-1] == 100.0


def test_append_rate_naming(tone_dsf, tmp_path):
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0, output_rate=88200,
        out_dir=tmp_path, dither=DitherType.NONE, filt=FilterType.EQUIRIPPLE,
        append_rate=True, base_dir=tone_dsf.parent, input_path=tone_dsf)
    assert conv.output_path().name == "tone_88_2K.wav"


def test_check_level(tone_dsf):
    conv = Converter.new_level_check(
        output_rate=352800, input_path=tone_dsf, fmt=FmtType.PLANAR,
        endian=Endianness.LSB_FIRST, channels=2, block_size=4096,
        input_rate=DsdRate.DSD64)
    db = conv.check_level()
    # 0.5 amplitude tone plus residual ultrasonic DSM noise: close to -6 dBFS
    assert -6.5 < db < -4.0


def test_check_level_partial_tile_ignores_pad_ringing(tmp_path):
    """A stream whose signal runs right up to EOF is idle-padded inside
    the final (partial) tile; the signal->pad splice transient rings
    ABOVE the true stream peak (measured: 0.688 vs 0.651 here, +0.48 dB)
    but lies entirely past n_valid. check_level must report the peak of
    the emitted frames only — the kernel's full-tile peak counted the
    ringing (round-3 review finding), and the sharded path already
    masked it, so the two modes disagreed."""
    from dsd2dxd_tpu.ops.dsm import bits_to_bytes_msb, dsm2_bits

    n = 4096 * 9 * 8  # bits; exactly 9 raw blocks, so EOF == signal end
    # half-cosine ramp 0 -> 0.65: no overshoot inside the valid region,
    # maximum discontinuity at the splice
    ramp = 0.65 * 0.5 * (1 - np.cos(np.pi * np.arange(n) / n))
    raw = tmp_path / "ramp.dsd"
    raw.write_bytes(bits_to_bytes_msb(dsm2_bits(ramp)).tobytes())

    peaks = []
    conv_f = Converter.new(
        bit_depth=32, output=OutputType.STDOUT, level_db=0.0,
        output_rate=88200, out_dir=None, dither=DitherType.NONE,
        fmt=FmtType.PLANAR, endian=Endianness.MSB_FIRST,
        input_rate=DsdRate.DSD64, block_size=4096, channels=1,
        filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
        input_path=raw)
    conv_f._run(None, None, lambda t: peaks.append(np.abs(t).max()))

    conv = Converter.new_level_check(
        output_rate=88200, input_path=raw, fmt=FmtType.PLANAR,
        endian=Endianness.MSB_FIRST, channels=1, block_size=4096,
        input_rate=DsdRate.DSD64)
    db = conv.check_level()
    assert abs(db - 20 * np.log10(max(peaks))) < 1e-4


def test_raw_file_roundtrip(tone_dsf, tmp_path):
    """A raw .dsd bitstream (planar, LSB-first — matching the 1kHz_mono_p
    fixture layout, SURVEY.md §4.2) through Converter.new."""
    from dsd2dxd_tpu.formats.dsf import open_dsf

    src, meta = open_dsf(tone_dsf)
    raw_path = tmp_path / "tone.dsd"
    # Reconstruct the raw planar payload (LSB-first bytes as stored).
    from dsd2dxd_tpu.formats.source import reverse_bits

    blocks = []
    while True:
        planes = src.read(4096)
        if planes is None:
            break
        blocks.append(reverse_bits(planes))  # back to LSB-first on disk
    full = np.concatenate(blocks, axis=1)
    with open(raw_path, "wb") as f:
        pad = (-full.shape[1]) % 4096
        padded = np.pad(full, ((0, 0), (0, pad)), constant_values=0x55)
        for off in range(0, padded.shape[1], 4096):
            f.write(padded[:, off:off + 4096].tobytes())

    conv = Converter.new(
        bit_depth=24, output=OutputType.WAV, level_db=0.0, output_rate=352800,
        out_dir=tmp_path, dither=DitherType.NONE, filt=FilterType.EQUIRIPPLE,
        fmt=FmtType.PLANAR, endian=Endianness.LSB_FIRST,
        input_rate=DsdRate.DSD64, block_size=4096, channels=2,
        append_rate=False, base_dir=tmp_path, input_path=raw_path)
    conv.do_conversion()
    fmt, data = _read_wav(tmp_path / "tone.wav")
    pcm = _decode_s24le(data, 2).astype(np.float64) / 2 ** 23
    x = pcm[20000:170000, 0]
    rms = np.sqrt(np.mean(x ** 2))
    assert abs(rms * np.sqrt(2) - 0.5) < 0.01


def test_dither_seed_policy(tone_dsf, tmp_path, monkeypatch):
    """Dither noise is reproducible per file but decorrelated across
    files (seed derived from the input path; the reference uses fresh
    entropy per run); DSD2DXD_SEED shifts the noise universe."""
    import shutil

    monkeypatch.delenv("DSD2DXD_SEED", raising=False)
    copy = tmp_path / "copy.dsf"
    shutil.copyfile(tone_dsf, copy)

    def convert(path, sub):
        out_dir = tmp_path / sub
        out_dir.mkdir(exist_ok=True)
        conv = Converter.from_container(
            bit_depth=16, output=OutputType.WAV, level_db=0.0,
            output_rate=88200, out_dir=out_dir, dither=DitherType.TPDF,
            filt=FilterType.EQUIRIPPLE, append_rate=False,
            base_dir=path.parent, input_path=path)
        conv.do_conversion()
        _, data = _read_wav(conv.output_path())
        return np.frombuffer(data, dtype=np.int16)

    a1 = convert(tone_dsf, "a1")
    a2 = convert(tone_dsf, "a2")
    np.testing.assert_array_equal(a1, a2)  # reproducible
    b = convert(copy, "b")
    assert a1.shape == b.shape
    assert not np.array_equal(a1, b)  # different path -> different noise
    monkeypatch.setenv("DSD2DXD_SEED", "take2")
    a3 = convert(tone_dsf, "a3")
    assert not np.array_equal(a1, a3)  # seed override -> new universe


def test_non_byte_aligned_sample_count_trims(tone_dsf, tmp_path):
    """A DSF whose sample_count is not a multiple of 8 must trim at the
    exact bit count: the up-to-7 padding bits in the final byte are not
    signal (reference dsf-meta semantics; ADVICE r1)."""
    raw = bytearray(tone_dsf.read_bytes())
    (orig_bits,) = struct.unpack("<Q", raw[64:72])
    cut_bits = orig_bits - 12  # not byte-aligned
    raw[64:72] = struct.pack("<Q", cut_bits)
    trimmed = tmp_path / "trimmed.dsf"
    trimmed.write_bytes(bytes(raw))

    out_frames = {}
    for name, path in (("orig", tone_dsf), ("trim", trimmed)):
        conv = Converter.from_container(
            bit_depth=24, output=OutputType.WAV, level_db=0.0,
            output_rate=352800, out_dir=tmp_path, dither=DitherType.NONE,
            filt=FilterType.EQUIRIPPLE, append_rate=False,
            base_dir=path.parent, input_path=path)
        conv.do_conversion()
        _, data = _read_wav(conv.output_path())
        out_frames[name] = len(data) // (3 * 2)
    assert out_frames["orig"] == int(orig_bits / 8)
    assert out_frames["trim"] == int(cut_bits / 8)


def test_drain_failure_stops_subsequent_writes(tone_dsf):
    """When a queued drain fails (disk full mid-stream), drains already
    queued behind it must NOT write: they would append frames after the
    failure point, turning a clean truncation into a file with a hole
    (round-3 review finding on the triple-overlap pipeline)."""
    calls = []

    def sink(t):
        calls.append(len(t))
        raise OSError("disk full")

    conv = Converter.from_container(
        bit_depth=32, output=OutputType.STDOUT, level_db=0.0,
        output_rate=88200, out_dir=None, dither=DitherType.NONE,
        filt=FilterType.EQUIRIPPLE, append_rate=False,
        base_dir=tone_dsf.parent, input_path=tone_dsf)
    conv.tile_target_bytes = 4096  # many tiles -> drains queue up
    with pytest.raises(OSError):
        conv._run(None, None, sink)
    assert len(calls) == 1  # nothing written past the failed tile


def test_cancel(tone_dsf, tmp_path):
    from dsd2dxd_tpu.utils.errors import CancelledError

    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0, output_rate=352800,
        out_dir=tmp_path, dither=DitherType.NONE, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=tone_dsf.parent, input_path=tone_dsf)
    with pytest.raises(CancelledError):
        conv.do_conversion(cancel=lambda: True)


def test_container_to_wav_njad(tone_dsf, tmp_path):
    """End-to-end NJAD conversion through the engine: device emits
    float32 tiles, the host requantizer (_make_sink wrap) quantizes to
    24-bit, the writer gets ints. Pins: valid WAV, |error| <= 1 LSB vs the
    float conversion, deterministic across runs, state freed."""
    kw = dict(bit_depth=24, output=OutputType.WAV, level_db=0.0,
              output_rate=352800, filt=FilterType.EQUIRIPPLE,
              append_rate=False, base_dir=tone_dsf.parent,
              input_path=tone_dsf)
    conv = Converter.from_container(out_dir=tmp_path / "n1",
                                    dither=DitherType.NJAD, **kw)
    conv.do_conversion()
    fmt, data = _read_wav(tmp_path / "n1" / "tone.wav")
    assert (fmt[0], fmt[5]) == (1, 24)
    got = _decode_s24le(data, 2).astype(np.int64)
    # float reference: same chain, no dither, 32f output
    conv_f = Converter.from_container(out_dir=tmp_path / "f",
                                      dither=DitherType.NONE,
                                      **{**kw, "bit_depth": 32})
    conv_f.do_conversion()
    fmt_f, data_f = _read_wav(tmp_path / "f" / "tone.wav")
    assert fmt_f[0] == 3
    ref = np.frombuffer(data_f, "<f4").reshape(-1, 2).astype(np.float64)
    n = min(len(got), len(ref))
    err = got[:n] - ref[:n] * (1 << 23)
    assert np.abs(err).max() <= 1.0 + 1e-6  # floor/ceil choice only
    # deterministic: NJAD has no RNG, state derives from the stream
    conv2 = Converter.from_container(out_dir=tmp_path / "n2",
                                     dither=DitherType.NJAD, **kw)
    conv2.do_conversion()
    _, data2 = _read_wav(tmp_path / "n2" / "tone.wav")
    assert data2 == data


@pytest.mark.parametrize("rate_hz,out_hz", [
    (22_579_200, 352800),   # DSD512 -> 352.8k: deepest input rate
    (11_289_600, 1411200),  # DSD256 -> 1411.2k: highest output rate
])
def test_deep_cells_through_container_path(rate_hz, out_hz, tmp_path):
    """The deep rate-matrix cells (SURVEY §2.5 frontier; VERDICT r3
    item 7) exercised through the FULL container->engine path — DSF
    parse, tile loop, dither, WAV write — not only via bare device
    steps. Fixture is a real written-and-reparsed .dsf."""
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    planes = synth_tone_dsd(1000.0, 0.1, rate_hz, amplitude=0.5,
                            channels=2)
    src = tmp_path / f"tone_{rate_hz}.dsf"
    write_dsf(src, planes, rate_hz, lsb_first=True)
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0,
        output_rate=out_hz, out_dir=tmp_path, dither=DitherType.TPDF,
        filt=FilterType.EQUIRIPPLE, append_rate=False,
        base_dir=tmp_path, input_path=src)
    conv.do_conversion()
    fmt, data = _read_wav(tmp_path / src.with_suffix(".wav").name)
    tag, ch, rate, _, _, bits = fmt
    assert (tag, ch, rate, bits) == (1, 2, out_hz, 24)
    pcm = _decode_s24le(data, 2).astype(np.float64) / 2 ** 23
    assert abs(len(pcm) - int(0.1 * out_hz)) < 2
    # tone survives the full path: correct frequency and level
    x = pcm[len(pcm) // 4:, 0]
    n = len(x)
    X = np.fft.rfft(x * np.hanning(n))
    freqs = np.fft.rfftfreq(n, 1 / out_hz)
    assert abs(freqs[np.argmax(np.abs(X))] - 1000.0) < 10.0
    rms = np.sqrt(np.mean(x ** 2))
    assert abs(rms * np.sqrt(2) - 0.5) < 0.01
