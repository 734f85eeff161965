"""WAV/AIFF/AIFC writer tests: re-parse everything we write
(golden round-trip strategy per SURVEY.md §4.3(e))."""

import struct
import wave

import numpy as np
import pytest

from dsd2dxd_tpu.containers.aiff import AiffWriter, _extended80
from dsd2dxd_tpu.containers.pack import pack, pack_int
from dsd2dxd_tpu.containers.wav import WavWriter


class TestPack:
    def test_s16le(self):
        x = np.array([0, 1, -1, 32767, -32768], dtype=np.int32)
        assert pack_int(x, 16) == struct.pack("<5h", 0, 1, -1, 32767, -32768)

    def test_s24le(self):
        x = np.array([0, 1, -1, 8388607, -8388608], dtype=np.int32)
        out = pack_int(x, 24)
        assert out == (
            b"\x00\x00\x00" b"\x01\x00\x00" b"\xff\xff\xff"
            b"\xff\xff\x7f" b"\x00\x00\x80"
        )

    def test_s24be(self):
        x = np.array([1, -1], dtype=np.int32)
        assert pack_int(x, 24, big_endian=True) == b"\x00\x00\x01\xff\xff\xff"

    def test_20_in_24(self):
        """20-bit value occupies the top 20 bits of the 24-bit word."""
        x = np.array([1, -1, 524287], dtype=np.int32)  # 20-bit full scale
        out = pack_int(x, 20)
        assert out == b"\x10\x00\x00" + b"\xf0\xff\xff" + b"\xf0\xff\x7f"

    def test_f32(self):
        x = np.array([0.5, -1.0], dtype=np.float32)
        assert pack(x, 32) == struct.pack("<2f", 0.5, -1.0)


class TestWav:
    def test_wav_16bit_roundtrip(self, tmp_path):
        path = tmp_path / "a.wav"
        samples = (np.sin(np.linspace(0, 10, 400)) * 20000).astype(np.int32)
        frames = samples.reshape(-1, 2)
        with open(path, "wb") as f:
            w = WavWriter(f, channels=2, sample_rate=88200, bit_depth=16)
            w.write(frames)
            w.finalize()
        with wave.open(str(path)) as r:
            assert r.getnchannels() == 2
            assert r.getframerate() == 88200
            assert r.getsampwidth() == 2
            assert r.getnframes() == 200
            data = np.frombuffer(r.readframes(200), dtype="<i2")
            np.testing.assert_array_equal(data, samples.astype(np.int16))

    def test_wav_24bit_header(self, tmp_path):
        path = tmp_path / "b.wav"
        with open(path, "wb") as f:
            w = WavWriter(f, channels=2, sample_rate=352800, bit_depth=24)
            w.write(np.zeros((16, 2), dtype=np.int32))
            w.finalize()
        with wave.open(str(path)) as r:
            assert r.getsampwidth() == 3
            assert r.getframerate() == 352800
            assert r.getnframes() == 16

    def test_wav_float_format_tag(self, tmp_path):
        path = tmp_path / "c.wav"
        with open(path, "wb") as f:
            w = WavWriter(f, channels=1, sample_rate=96000, bit_depth=32)
            w.write(np.zeros((8, 1), dtype=np.float32))
            w.finalize()
        raw = path.read_bytes()
        fmt_off = raw.index(b"fmt ")
        tag, ch = struct.unpack_from("<HH", raw, fmt_off + 8)
        assert tag == 3  # IEEE float
        bits = struct.unpack_from("<H", raw, fmt_off + 22)[0]
        assert bits == 32

    def test_wav_float_has_fact_chunk(self, tmp_path):
        """The RIFF spec requires a fact chunk (dwSampleLength) for any
        non-PCM format tag; strict readers reject float WAVs without
        one. PCM int output must NOT grow one."""
        path = tmp_path / "cf.wav"
        with open(path, "wb") as f:
            w = WavWriter(f, channels=2, sample_rate=96000, bit_depth=32)
            w.write(np.zeros((37, 2), dtype=np.float32))
            w.finalize()
        raw = path.read_bytes()
        off = raw.index(b"fact")
        size, frames = struct.unpack_from("<II", raw, off + 4)
        assert (size, frames) == (4, 37)
        assert off < raw.index(b"data")  # fact precedes data
        # riff size field accounts for the extra chunk exactly
        (riff,) = struct.unpack_from("<I", raw, 4)
        assert riff == len(raw) - 8
        with open(tmp_path / "ci.wav", "wb") as f:
            w = WavWriter(f, channels=2, sample_rate=96000, bit_depth=24)
            w.write(np.zeros((4, 2), dtype=np.int32))
            w.finalize()
        assert b"fact" not in (tmp_path / "ci.wav").read_bytes()

    def test_wav_with_id3_chunk(self, tmp_path):
        from dsd2dxd_tpu.formats.id3 import Id3Tag, parse_id3

        tag = Id3Tag()
        tag.set_text("TIT2", "X")
        path = tmp_path / "d.wav"
        with open(path, "wb") as f:
            w = WavWriter(f, channels=1, sample_rate=44100, bit_depth=16,
                          id3=tag.to_bytes())
            w.write(np.zeros((4, 1), dtype=np.int32))
            w.finalize()
        raw = path.read_bytes()
        off = raw.index(b"id3 ")
        (size,) = struct.unpack_from("<I", raw, off + 4)
        back = parse_id3(raw[off + 8: off + 8 + size])
        assert back.get_text("TIT2") == "X"
        # wave module must still read it (chunk ordering valid)
        with wave.open(str(path)) as r:
            assert r.getnframes() == 4


class TestAiff:
    def test_extended80(self):
        # Known encodings for common rates
        assert _extended80(44100.0).hex() == "400eac44000000000000"
        assert _extended80(352800.0).hex() == "4011ac44000000000000"

    def test_aiff_roundtrip_stdlib(self, tmp_path):
        aifc_mod = pytest.importorskip("aifc")
        path = tmp_path / "a.aif"
        samples = (np.arange(-100, 100, dtype=np.int32) * 1000)
        with open(path, "wb") as f:
            w = AiffWriter(f, channels=2, sample_rate=176400, bit_depth=16)
            w.write(samples.reshape(-1, 2))
            w.finalize()
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = aifc_mod.open(str(path))
        assert r.getnchannels() == 2
        assert r.getframerate() == 176400
        assert r.getsampwidth() == 2
        data = np.frombuffer(r.readframes(100), dtype=">i2")
        np.testing.assert_array_equal(data, samples.astype(np.int16))

    def test_aifc_float_structure(self, tmp_path):
        path = tmp_path / "a.aifc"
        with open(path, "wb") as f:
            w = AiffWriter(f, channels=2, sample_rate=384000, bit_depth=32,
                           aifc=True)
            w.write(np.full((10, 2), 0.25, dtype=np.float32))
            w.finalize()
        raw = path.read_bytes()
        assert raw[8:12] == b"AIFC"
        assert b"FVER" in raw and b"fl32" in raw
        comm = raw.index(b"COMM")
        ch, frames, bits = struct.unpack_from(">hIh", raw, comm + 8)
        assert (ch, frames, bits) == (2, 10, 32)
        ssnd = raw.index(b"SSND")
        first = struct.unpack_from(">f", raw, ssnd + 16)[0]
        assert first == 0.25

    def test_aiff_24bit_payload_is_bigendian(self, tmp_path):
        path = tmp_path / "b.aif"
        with open(path, "wb") as f:
            w = AiffWriter(f, channels=1, sample_rate=88200, bit_depth=24)
            w.write(np.array([[1]], dtype=np.int32))
            w.finalize()
        raw = path.read_bytes()
        ssnd = raw.index(b"SSND")
        assert raw[ssnd + 16: ssnd + 19] == b"\x00\x00\x01"


def test_wav_over_4gib_header_clamps_instead_of_crashing():
    """RIFF size fields are 32-bit; finalize after a >4 GiB conversion
    must clamp with a warning (readers use EOF), not struct.error AFTER
    the audio was fully written (leaving the zero-size init header)."""
    import io

    buf = io.BytesIO()
    w = WavWriter(buf, channels=2, sample_rate=352800, bit_depth=24)
    w._data_bytes = 5 * 2 ** 30  # pretend 5 GiB of payload were written
    w.finalize()  # must not raise
    raw = buf.getvalue()
    assert struct.unpack("<I", raw[4:8])[0] == 0xFFFFFFFF
    data_at = raw.index(b"data")
    assert struct.unpack("<I", raw[data_at + 4:data_at + 8])[0] == 0xFFFFFFFF


def test_aiff_over_4gib_header_clamps_instead_of_crashing():
    import io

    buf = io.BytesIO()
    w = AiffWriter(buf, channels=2, sample_rate=352800, bit_depth=24)
    w._data_bytes = 5 * 2 ** 30
    w.finalize()
    raw = buf.getvalue()
    assert struct.unpack(">I", raw[4:8])[0] == 0xFFFFFFFF
    ssnd = raw.index(b"SSND")
    assert struct.unpack(">I", raw[ssnd + 4:ssnd + 8])[0] <= 0xFFFFFFFF


def test_flac_oversized_picture_dropped_not_crashed():
    """A >16 MiB APIC cannot fit a FLAC metadata block's 24-bit length:
    it must be dropped with a warning, not OverflowError the whole
    conversion."""
    import io

    from dsd2dxd_tpu.containers.flac import FlacWriter
    from dsd2dxd_tpu.formats.id3 import Id3Tag

    img = b"\xff\xd8" + bytes(17 * 1024 * 1024)
    apic = b"\x00image/jpeg\x00\x03big\x00" + img
    tag = Id3Tag()
    tag.set_text("TIT2", "Tone")
    from dsd2dxd_tpu.formats.id3 import Id3Frame

    tag.frames.append(Id3Frame("APIC", apic))
    buf = io.BytesIO()
    w = FlacWriter(buf, 2, 88200, 16, id3=tag.to_bytes())  # must not raise
    w.write(np.zeros((4096, 2), dtype=np.int32))
    w.finalize()
    from dsd2dxd_tpu.formats.flac_decode import decode_flac

    st = decode_flac(buf.getvalue())
    assert st.md5_ok
    assert st.comments.get("TITLE") == "Tone"
    assert not st.pictures  # oversized art dropped, audio intact
