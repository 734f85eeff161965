"""System-level suites mirroring the reference's shell tests
(SURVEY.md §4.1: run_all_tests.sh / test_all_44k_mults.sh /
test_all_48k_mults.sh), upgraded from ear+smoke checks to math oracles.
"""

import io
import struct

import numpy as np
import pytest

from dsd2dxd_tpu.cli import dsd2dxd as cli
from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    DsdRate,
    FilterType,
    OutputType,
    valid_output_rates,
)
from dsd2dxd_tpu.pipeline.engine import Converter

RATE_HZ = {DsdRate.DSD64: 2_822_400, DsdRate.DSD128: 5_644_800,
           DsdRate.DSD256: 11_289_600, DsdRate.DSD512: 22_579_200}


@pytest.fixture(scope="module")
def tone_dsf_by_rate(tmp_path_factory):
    """Short 1 kHz stereo DSF at each DSD rate (synthesized stand-ins for
    the stripped fixtures — SURVEY.md §4.2)."""
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    root = tmp_path_factory.mktemp("matrix")
    paths = {}
    for rate in DsdRate:
        hz = RATE_HZ[rate]
        seconds = max(0.12, 2_000_000 / hz)  # keep synthesis time bounded
        planes = synth_tone_dsd(1000.0, seconds, hz, amplitude=0.5,
                                channels=2)
        p = root / f"tone_{rate.name.lower()}.dsf"
        write_dsf(p, planes, hz, lsb_first=True)
        paths[rate] = p
    return paths


ALL_CELLS = [(r, out) for r in DsdRate for out in valid_output_rates(r)]


@pytest.mark.parametrize("in_rate,out_hz", ALL_CELLS)
def test_rate_matrix_cell(in_rate, out_hz, tone_dsf_by_rate, tmp_path):
    """Every cell of the SURVEY §2.5 matrix (test_all_44k_mults.sh +
    test_all_48k_mults.sh): convert and verify rate, duration, and tone."""
    src = tone_dsf_by_rate[in_rate]
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0, output_rate=out_hz,
        out_dir=tmp_path, dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src)
    conv.do_conversion()
    raw = conv.output_path().read_bytes()
    rate = struct.unpack("<I", raw[24:28])[0]
    assert rate == out_hz
    # data chunk
    pos = raw.index(b"data")
    (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
    data = raw[pos + 8:pos + 8 + size]
    n_frames = len(data) // 6
    in_hz = RATE_HZ[in_rate]
    # duration scales with the rate ratio (within one output sample)
    from dsd2dxd_tpu.formats.dsf import open_dsf

    _, meta = open_dsf(src)
    expect = meta.sample_count * out_hz // in_hz
    assert abs(n_frames - expect) <= 1
    # 1 kHz tone present at correct amplitude
    b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
    vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16))
    vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
    x = vals.reshape(-1, 2)[:, 0].astype(np.float64) / 2 ** 23
    skip = min(len(x) // 4, 4000)
    x = x[skip:]
    n = len(x)
    X = np.abs(np.fft.rfft(x * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1 / out_hz)
    assert abs(freqs[np.argmax(X)] - 1000.0) < 25.0
    rms = np.sqrt(np.mean(x ** 2))
    assert abs(rms * np.sqrt(2) - 0.5) < 0.03


def test_six_channel_dsf_to_wav(tmp_path):
    """5.1-style 6-channel DSF end-to-end through the engine: DSF channel
    counts go up to 6 (channel type 7) and the reference converts them
    like any other planar source. Asserts channel count, frame count, and
    the per-channel tone (each channel gets a distinct phase so a
    channel-swap or row-padding bug shows up as amplitude loss)."""
    from dsd2dxd_tpu.formats.dsf import open_dsf, write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    hz, out_hz = 2_822_400, 352_800
    planes = synth_tone_dsd(1000.0, 0.25, hz, amplitude=0.4, channels=6,
                            phase_per_ch=0.7)
    src = tmp_path / "tone6.dsf"
    write_dsf(src, planes, hz, lsb_first=True)
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=0.0,
        output_rate=out_hz, out_dir=tmp_path, dither=DitherType.TPDF,
        filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
        input_path=src)
    conv.do_conversion()
    raw = conv.output_path().read_bytes()
    ch = struct.unpack("<H", raw[22:24])[0]
    rate = struct.unpack("<I", raw[24:28])[0]
    assert (ch, rate) == (6, out_hz)
    pos = raw.index(b"data")
    (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
    data = raw[pos + 8:pos + 8 + size]
    n_frames = len(data) // (6 * 3)
    _, meta = open_dsf(src)
    assert abs(n_frames - meta.sample_count * out_hz // hz) <= 1
    b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 6, 3)
    vals = (b[..., 0].astype(np.int32) | (b[..., 1].astype(np.int32) << 8)
            | (b[..., 2].astype(np.int32) << 16))
    vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
    x = vals[4000:].astype(np.float64) / 2 ** 23
    n = len(x)
    freqs = np.fft.rfftfreq(n, 1 / out_hz)
    for c in range(6):
        X = np.abs(np.fft.rfft(x[:, c] * np.hanning(n)))
        assert abs(freqs[np.argmax(X)] - 1000.0) < 25.0
        rms = np.sqrt(np.mean(x[:, c] ** 2))
        assert abs(rms * np.sqrt(2) - 0.4) < 0.03


def test_umbrella_stdin_plus_dir(tone_dsf_by_rate, tmp_path, monkeypatch,
                                 capsysbinary):
    """The run_all_tests.sh:11 umbrella line:
    dsd2dxd -R -a -o w -f p -e l -r 88200 -p out <dir> -  < raw.dsd
    — recursion + append-rate + WAV + output tree + stdin in ONE call."""
    # Tree with only 88.2k-compatible inputs (the reference's test dir is
    # DSD64/DSD128 — a DSD512 file would correctly fail-fast the batch).
    import shutil

    src_dir = tmp_path / "in"
    (src_dir / "sub").mkdir(parents=True)
    shutil.copy(tone_dsf_by_rate[DsdRate.DSD64], src_dir / "a64.dsf")
    shutil.copy(tone_dsf_by_rate[DsdRate.DSD128], src_dir / "sub" / "b128.dsf")
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    # raw planar LSB stdin payload
    from dsd2dxd_tpu.formats.dsf import open_dsf
    from dsd2dxd_tpu.formats.source import reverse_bits

    src, _ = open_dsf(tone_dsf_by_rate[DsdRate.DSD64])
    blocks = []
    while True:
        p = src.read(65536)
        if p is None:
            break
        blocks.append(reverse_bits(p))
    payload = np.concatenate(blocks, axis=1)
    pad = (-payload.shape[1]) % 4096
    payload = np.pad(payload, ((0, 0), (0, pad)), constant_values=0x55)
    raw = b"".join(payload[:, o:o + 4096].tobytes()
                   for o in range(0, payload.shape[1], 4096))
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(raw)))

    rc = cli.run(["-R", "-a", "-o", "w", "-f", "p", "-e", "l",
                  "-r", "88200", "-p", str(out_dir), str(src_dir), "-",
                  "-q"])
    assert rc == 0
    # stdin lands as output_88_2K.wav in -p (reference run_all_tests.sh:11)
    assert (out_dir / "output_88_2K.wav").exists()
    # tree mirrored with the rate suffix, relative to base_dir =
    # src_dir.parent (main.rs:266), so the input dir name is kept
    assert (out_dir / "in" / "a64_88_2K.wav").exists()
    assert (out_dir / "in" / "sub" / "b128_88_2K.wav").exists()


def test_20bit_rides_in_24bit_container(tone_dsf_by_rate, tmp_path):
    """build_test_mono.sh's 20-bit special case: 20-bit WAV output is a
    24-bit container with the 20 significant bits at the top."""
    src = tone_dsf_by_rate[DsdRate.DSD64]
    conv = Converter.from_container(
        bit_depth=20, output=OutputType.WAV, level_db=0.0, output_rate=88200,
        out_dir=tmp_path, dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src)
    conv.do_conversion()
    raw = conv.output_path().read_bytes()
    fmt = struct.unpack("<HHIIHH", raw[raw.index(b"fmt ") + 8:][:16])
    assert fmt[5] == 24  # container bits
    pos = raw.index(b"data")
    (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
    b = np.frombuffer(raw[pos + 8:pos + 8 + size], dtype=np.uint8)
    # low 4 bits of every sample's low byte are zero (<<4 shift)
    assert (b.reshape(-1, 3)[:, 0] & 0x0F).max() == 0


def test_float_output_path(tone_dsf_by_rate, tmp_path):
    """build_test_stereo_flt.sh: 32-bit float + Dither Float."""
    src = tone_dsf_by_rate[DsdRate.DSD64]
    conv = Converter.from_container(
        bit_depth=32, output=OutputType.WAV, level_db=-3.0,
        output_rate=176400, out_dir=tmp_path, dither=DitherType.FPD,
        filt=FilterType.EQUIRIPPLE, append_rate=False,
        base_dir=src.parent, input_path=src)
    conv.do_conversion()
    raw = conv.output_path().read_bytes()
    fmt = struct.unpack("<HHIIHH", raw[raw.index(b"fmt ") + 8:][:16])
    assert fmt[0] == 3 and fmt[5] == 32  # IEEE float
    pos = raw.index(b"data")
    (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
    x = np.frombuffer(raw[pos + 8:pos + 8 + size], dtype="<f4")
    x = x.reshape(-1, 2)[2000:, 0].astype(np.float64)
    rms = np.sqrt(np.mean(x ** 2))
    expect = 0.5 * 10 ** (-3 / 20)
    assert abs(rms * np.sqrt(2) - expect) < 0.02


def test_peak_matches_conversion_output(tone_dsf_by_rate):
    """Property (SURVEY §4.3): dsd_levels peak == max |sample| of the
    float conversion at the same rate."""
    from dsd2dxd_tpu.formats.dsd_types import Endianness, FmtType

    src = tone_dsf_by_rate[DsdRate.DSD64]
    conv = Converter.new_level_check(
        output_rate=352800, input_path=src, fmt=FmtType.PLANAR,
        endian=Endianness.LSB_FIRST, channels=2, block_size=4096,
        input_rate=DsdRate.DSD64)
    db = conv.check_level()
    peaks = []
    conv2 = Converter.from_container(
        bit_depth=32, output=OutputType.STDOUT, level_db=0.0,
        output_rate=352800, out_dir=None, dither=DitherType.NONE,
        filt=FilterType.EQUIRIPPLE, append_rate=False,
        base_dir=src.parent, input_path=src)
    peak = conv2._run(None, None, lambda t: peaks.append(np.abs(t).max()))
    assert abs(db - 20 * np.log10(max(peaks))) < 0.01
    assert abs(peak - max(peaks)) < 1e-6


def test_baseline_config3_flac_20bit_njad(tone_dsf_by_rate, tmp_path):
    """BASELINE.md config 3 end-to-end on CPU: DSD128 -> 20-bit 88.2k
    FLAC with NJAD. The first engine-level FLAC conversion in the suite
    — everything upstream tested the writer/native layers directly.
    Pins: oracle-decoded MD5, 20 bps carried natively, rate/frames,
    tone at 1 kHz, and NJAD's <=1 LSB20 error bound vs a float run."""
    from dsd2dxd_tpu.formats.flac_decode import decode_flac

    pytest.importorskip("dsd2dxd_tpu.native")
    src = tone_dsf_by_rate[DsdRate.DSD128]
    kw = dict(output_rate=88200, level_db=0.0,
              filt=FilterType.EQUIRIPPLE, append_rate=False,
              base_dir=src.parent, input_path=src)
    conv = Converter.from_container(
        bit_depth=20, output=OutputType.FLAC, dither=DitherType.NJAD,
        out_dir=tmp_path / "c3", **kw)
    conv.do_conversion()
    out = conv.output_path()
    assert out.suffix == ".flac" and out.exists()
    st = decode_flac(out.read_bytes())
    assert st.md5_ok
    assert st.bits_per_sample == 20
    assert st.sample_rate == 88200
    dur = RATE_HZ[DsdRate.DSD128] and st.samples.shape[0] / 88200
    # fixture length: seconds = max(0.12, 2e6/hz)
    assert abs(dur - max(0.12, 2_000_000 / RATE_HZ[DsdRate.DSD128])) < 0.01
    x = st.samples[:, 0].astype(np.float64) / 2 ** 19
    n = len(x)
    X = np.abs(np.fft.rfft(x * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1 / 88200)
    assert abs(freqs[np.argmax(X)] - 1000.0) < 5.0
    # NJAD error bound vs the float conversion (floor/ceil choice only)
    conv_f = Converter.from_container(
        bit_depth=32, output=OutputType.WAV, dither=DitherType.NONE,
        out_dir=tmp_path / "f", **kw)
    conv_f.do_conversion()
    raw = conv_f.output_path().read_bytes()
    d = raw.index(b"data")
    ref = np.frombuffer(raw, "<f4", offset=d + 8).reshape(-1, 2)
    m = min(len(ref), len(st.samples))
    err = st.samples[:m].astype(np.float64) - ref[:m] * 2 ** 19
    assert np.abs(err).max() <= 1.0 + 1e-6


def test_engine_flac_24bit_tpdf(tone_dsf_by_rate, tmp_path):
    """24-bit TPDF FLAC through the engine (the config-1-with-FLAC
    shape): oracle MD5 + amplitude sanity."""
    from dsd2dxd_tpu.formats.flac_decode import decode_flac

    pytest.importorskip("dsd2dxd_tpu.native")
    src = tone_dsf_by_rate[DsdRate.DSD64]
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.FLAC, dither=DitherType.TPDF,
        output_rate=352800, level_db=0.0, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src,
        out_dir=tmp_path)
    conv.do_conversion()
    st = decode_flac(conv.output_path().read_bytes())
    assert st.md5_ok and st.bits_per_sample == 24
    x = st.samples[:, 0].astype(np.float64) / 2 ** 23
    rms = np.sqrt(np.mean(x ** 2))
    assert abs(rms * np.sqrt(2) - 0.5) < 0.02


def test_baseline_config4_aifc_float(tone_dsf_by_rate, tmp_path):
    """BASELINE.md config 4 shape on CPU: DSD256 -> 384k 32-bit float
    AIFC with FPD dither, through the engine (the suite had no
    engine-level AIFF/AIFC conversion). Walks the AIFC chunks directly:
    fl32 compression tag, float payload, 1 kHz tone."""
    src = tone_dsf_by_rate[DsdRate.DSD256]
    conv = Converter.from_container(
        bit_depth=32, output=OutputType.AIFC, dither=DitherType.FPD,
        output_rate=384000, level_db=0.0, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src,
        out_dir=tmp_path)
    conv.do_conversion()
    out = conv.output_path()
    assert out.suffix == ".aifc" and out.exists()
    raw = out.read_bytes()
    assert raw[:4] == b"FORM" and raw[8:12] == b"AIFC"
    comm = raw.index(b"COMM")
    ch, frames, bits = struct.unpack_from(">hIh", raw, comm + 8)
    assert (ch, bits) == (2, 32)
    # COMM body: ch(2) frames(4) bits(2) extended-80 rate(10) then tag
    assert raw[comm + 8 + 18:comm + 8 + 22] == b"fl32"
    ssnd = raw.index(b"SSND")
    x = np.frombuffer(raw, ">f4", count=frames * 2,
                      offset=ssnd + 16).reshape(-1, 2)
    assert len(x) == frames
    sec = max(0.12, 2_000_000 / RATE_HZ[DsdRate.DSD256])
    assert abs(frames / 384000 - sec) < 0.01
    w = x[2000:, 0].astype(np.float64)
    X = np.abs(np.fft.rfft(w * np.hanning(len(w))))
    freqs = np.fft.rfftfreq(len(w), 1 / 384000)
    assert abs(freqs[np.argmax(X)] - 1000.0) < 6.0


def test_engine_aiff_24bit_with_id3(tmp_path):
    """24-bit AIFF through the engine from a DFF source with ID3: the
    tag must ride along in an 'ID3 ' chunk (the id3-crate convention)
    and stdlib aifc must read the audio. Completes engine-level
    coverage of all five output types."""
    from dsd2dxd_tpu.formats.dff import write_dff
    from dsd2dxd_tpu.formats.id3 import Id3Frame, Id3Tag
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    aifc_mod = pytest.importorskip("aifc")
    src = tmp_path / "in" / "tone.dff"
    src.parent.mkdir()
    tag_in = Id3Tag(frames=[
        Id3Frame.text_frame("TIT2", "1kHz Test Tone DSD64"),
        Id3Frame.text_frame("TPE1", "dsd2dxd")])
    write_dff(src, synth_tone_dsd(1000.0, 0.25, 2_822_400, amplitude=0.5,
                                  channels=2),
              2_822_400, id3=tag_in.to_bytes())
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.AIFF, dither=DitherType.TPDF,
        output_rate=88200, level_db=0.0, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src,
        out_dir=tmp_path / "out")
    conv.do_conversion()
    out = conv.output_path()
    assert out.suffix == ".aif" and out.exists()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = aifc_mod.open(str(out))
    assert (r.getnchannels(), r.getsampwidth(), r.getframerate()) \
        == (2, 3, 88200)
    assert r.getnframes() > 0
    raw = out.read_bytes()
    from dsd2dxd_tpu.formats.id3 import parse_id3
    off = raw.index(b"ID3 ")
    (size,) = struct.unpack_from(">I", raw, off + 4)
    tag = parse_id3(raw[off + 8: off + 8 + size])
    assert tag is not None
    assert tag.get_text("TIT2") == "1kHz Test Tone DSD64"
