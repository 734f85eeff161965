"""Smoke test of the transcoder's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: cells A-F, then the
                                       # gpu-marked tests
    python chip_smoke.py --four-cards  # four cards: a file batch and one
                                       # long sharded file, each against
                                       # one card

Cells (the BASELINE.md configs at album-length sizes; the input is a
-6 dBFS 1 kHz DSD tone, the committed one-second tones in bench_cache/
repeated):

  A  DSD64 stereo .dsf, 180 s -> 24-bit/352.8k WAV, TPDF   (CLI run)
  B  raw interleaved DSD64, 60 s -> s24le/176.4k to stdout  (Converter.new)
  C  DSD128 .dff with ID3, 60 s -> 20-bit/88.2k FLAC, NJAD (CLI run)
  D  DSD256 .dsf, 60 s -> 24-bit/192k FLAC, TPDF           (CLI run)
  E  DSD512 .dsf, 30 s -> 32-bit float/352.8k AIFC, FPD     (Converter)
  F  cell A's file -> peak dBFS                             (dsd_levels)

Each cell is converted twice (cold, then warm) and its output checked:
frame count, FFT peak at 1 kHz, container header, the ID3 tag carried
into FLAC as Vorbis comments, and the first FLAC frames decoding through
formats/flac_decode.py. For A, D and E the device output is also held
to the f64 upfirdn oracle over a 1 s window across a tile boundary.

The script runs in one process and starts none that imports JAX. It
exits with code 2, printing no result, unless JAX's backend is a GPU;
with code 1 if any phase failed. Its last stdout line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import struct
import sys
import time
import types
from dataclasses import dataclass
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
LSB24 = 2.0 ** -23
# f32 error bounds against the f64 oracle (tests/test_phase.py): RMS
# below the 24-bit TPDF dither floor (sqrt(1/6) LSB), max under 4 LSB.
RMS_BOUND_LSB = 0.41
MAX_BOUND_LSB = 4.0
# Quantizing both sides cannot widen a float difference beyond its
# ceiling (tests/test_phase_int_oracle.py).
INT_BOUND_LSB = 4


@dataclass(frozen=True)
class Cell:
    name: str
    container: str      # "dsf", "dff" or "raw"
    rate_hz: int        # DSD bit rate
    seconds: float
    output: str         # dsd2dxd -o: W, S, F or C
    bits: int
    out_hz: int
    dither: str         # dsd2dxd -d: T, N, F or X
    id3: bool = False
    oracle: bool = False
    via: str = "cli"    # entry point: "cli" (dsd2dxd run) or "converter"


# E runs first, so that its peak_bytes_in_use is its own
CELLS = (
    Cell("E", "dsf", 22_579_200, 30.0, "C", 32, 352_800, "F", oracle=True,
         via="converter"),
    Cell("D", "dsf", 11_289_600, 60.0, "F", 24, 192_000, "T", oracle=True),
    Cell("C", "dff", 5_644_800, 60.0, "F", 20, 88_200, "N", id3=True),
    Cell("B", "raw", 2_822_400, 60.0, "S", 24, 176_400, "T",
         via="converter"),
    Cell("A", "dsf", 2_822_400, 180.0, "W", 24, 352_800, "T", oracle=True),
)
ID3_TITLE = "1kHz Test Tone"


def describe(cell: Cell) -> str:
    out = {"W": "WAV", "S": "stdout", "F": "FLAC", "C": "AIFC"}[cell.output]
    depth = "32f" if cell.bits == 32 else f"{cell.bits}-bit"
    return (f"DSD{cell.rate_hz // 44100} {cell.container} {cell.seconds:g} s"
            f"{' +ID3' if cell.id3 else ''} -> {depth}/{cell.out_hz} "
            f"{out}, dither {cell.dither}")


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


def tone_planes(rate_hz: int, seconds: float, channels: int = 2):
    """(channels, bytes) MSB-first DSD of a -6 dBFS 1 kHz tone: the
    committed one-second tone repeated, or synthesized for lengths
    under a second."""
    n_bytes = int(round(seconds * rate_hz)) // 8
    cached = REPO / "bench_cache" / f"tone_{rate_hz}_{channels}.npy"
    if seconds >= 1.0 and cached.exists():
        one = np.load(cached)
        return np.tile(one, (1, -(-n_bytes // one.shape[1])))[:, :n_bytes]
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    return synth_tone_dsd(1000.0, n_bytes * 8 / rate_hz, rate_hz,
                          amplitude=0.5, channels=channels)


def write_fixture(cell: Cell, planes, path: Path) -> Path:
    """Write `planes` in the cell's container (raw: byte-interleaved
    MSB-first, like 1kHz_stereo_i.dsd)."""
    from dsd2dxd_tpu.formats.dff import write_dff
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.formats.id3 import Id3Frame, Id3Tag

    id3 = None
    if cell.id3:
        id3 = Id3Tag(frames=[Id3Frame.text_frame("TIT2", ID3_TITLE),
                             Id3Frame.text_frame("TPE1", "dsd2dxd"),
                             Id3Frame.text_frame("TALB", "Smoke")]).to_bytes()
    if cell.container == "dsf":
        write_dsf(path, planes, cell.rate_hz, lsb_first=True, id3=id3)
    elif cell.container == "dff":
        write_dff(path, planes, cell.rate_hz, id3=id3)
    else:
        path.write_bytes(np.ascontiguousarray(planes.T).tobytes())
    return path


def build_fixture(cell: Cell, work: Path) -> Path:
    ext = {"dsf": "dsf", "dff": "dff", "raw": "dsd"}[cell.container]
    return write_fixture(cell, tone_planes(cell.rate_hz, cell.seconds),
                         work / f"cell{cell.name}.{ext}")


# ---------------------------------------------------------------------------
# Conversions through the user entry points
# ---------------------------------------------------------------------------


def _enums(cell: Cell):
    from dsd2dxd_tpu.formats.dsd_types import DitherType, OutputType

    return OutputType.from_char(cell.output), DitherType.from_char(cell.dither)


def make_converter(cell: Cell, src: Path, out_dir: Path, dither=None,
                   bits=None, output=None, device=None):
    """The Converter the cell's conversion builds (also used to read its
    step configuration)."""
    from dsd2dxd_tpu.formats.dsd_types import (
        DsdRate,
        Endianness,
        FilterType,
        FmtType,
    )
    from dsd2dxd_tpu.pipeline.engine import Converter

    out_t, dith = _enums(cell)
    kw = dict(bit_depth=bits or cell.bits, output=output or out_t,
              level_db=0.0, output_rate=cell.out_hz, out_dir=out_dir,
              dither=dither or dith, filt=FilterType.EQUIRIPPLE,
              append_rate=False, base_dir=src.parent,
              input_path=src.resolve(), device=device)
    if cell.container == "raw":
        return Converter.new(fmt=FmtType.INTERLEAVED,
                             endian=Endianness.MSB_FIRST,
                             input_rate=DsdRate.from_multiplier(
                                 cell.rate_hz // 2_822_400),
                             block_size=4096, channels=2, **kw)
    return Converter.from_container(**kw)


def convert(cell: Cell, src: Path, out_dir: Path) -> tuple[float, Path]:
    """One conversion of the cell through its entry point; returns (wall
    seconds, output file). Stdout output goes to a file."""
    from dsd2dxd_tpu.cli.dsd2dxd import run

    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if cell.via == "cli":
        rc = run(["-q", "-o", cell.output, "-b", str(cell.bits), "-r",
                  str(cell.out_hz), "-d", cell.dither, "-p", str(out_dir),
                  str(src)])
        wall = time.perf_counter() - t0
        assert rc == 0, f"dsd2dxd exited {rc}"
        (out,) = [p for p in out_dir.rglob("*") if p.is_file()]
        return wall, out
    conv = make_converter(cell, src, out_dir)
    if cell.output != "S":
        conv.do_conversion()
        return time.perf_counter() - t0, conv.output_path()
    out = out_dir / "stdout.s24le"
    real = sys.stdout
    with open(out, "wb") as f:
        sys.stdout = types.SimpleNamespace(buffer=f)
        try:
            conv.do_conversion()
        finally:
            sys.stdout = real
    return time.perf_counter() - t0, out


def level_check(src: Path, out_hz: int) -> tuple[float, float]:
    """dsd_levels on one file; returns (wall seconds, peak dBFS)."""
    from dsd2dxd_tpu.cli import dsd_levels

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = dsd_levels.run(["-q", "-r", str(out_hz), str(src)])
    wall = time.perf_counter() - t0
    assert rc == 0, f"dsd_levels exited {rc}: {err.getvalue()}"
    m = re.search(r"peak level = (-?[\d.]+|-inf) dBFS", err.getvalue())
    assert m, err.getvalue()
    return wall, float(m.group(1))


# ---------------------------------------------------------------------------
# Output checks
# ---------------------------------------------------------------------------


def read_wav(path: Path):
    """(fmt_tag, channels, rate, bits, (frames, C) array view)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    assert bytes(raw[:4]) == b"RIFF" and bytes(raw[8:12]) == b"WAVE"
    pos, fmt = 12, None
    while pos + 8 <= raw.size:
        cid = bytes(raw[pos:pos + 4])
        (size,) = struct.unpack("<I", bytes(raw[pos + 4:pos + 8]))
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", bytes(raw[pos + 8:pos + 24]))
        elif cid == b"data":
            tag, ch, rate, _br, _ba, bits = fmt
            data = raw[pos + 8:pos + 8 + size]
            return tag, ch, rate, bits, _samples(data, bits, ch, tag == 3)
        pos += 8 + size + (size & 1)
    raise AssertionError(f"{path}: no data chunk")


class Pcm24:
    """Interleaved 24-bit PCM bytes, decoded only for the frames a
    slice asks for (an album-length file stays on disk)."""

    def __init__(self, data, ch: int):
        self.b = data.reshape(-1, ch, 3)

    def __len__(self) -> int:
        return self.b.shape[0]

    def __getitem__(self, key):
        rows, rest = (key[0], key[1:]) if isinstance(key, tuple) else (key, ())
        b = np.asarray(self.b[rows], dtype=np.int32)
        v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return v[(slice(None),) + rest] if rest else v


def _samples(data, bits: int, ch: int, is_float: bool, big=False):
    if is_float:
        return data.view(">f4" if big else "<f4").reshape(-1, ch)
    assert bits in (20, 24) and not big, (bits, big)
    return Pcm24(data, ch)


def read_aifc(path: Path):
    """(channels, frames, bits, compression, (frames, C) float view)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    assert bytes(raw[:4]) == b"FORM" and bytes(raw[8:12]) == b"AIFC"
    pos, comm = 12, None
    while pos + 8 <= raw.size:
        cid = bytes(raw[pos:pos + 4])
        (size,) = struct.unpack(">I", bytes(raw[pos + 4:pos + 8]))
        if cid == b"COMM":
            ch, frames, bits = struct.unpack(">hIh",
                                             bytes(raw[pos + 8:pos + 16]))
            comm = (ch, frames, bits, bytes(raw[pos + 26:pos + 30]))
        elif cid == b"SSND":
            (offset,) = struct.unpack(">I", bytes(raw[pos + 8:pos + 12]))
            data = raw[pos + 16 + offset:pos + 8 + size]
            ch = comm[0]
            return (*comm, _samples(data, 32, ch, True, big=True))
        pos += 8 + size + (size & 1)
    raise AssertionError(f"{path}: no SSND chunk")


def peak_hz(x: np.ndarray, rate: int) -> float:
    x = np.asarray(x, dtype=np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.fft.rfftfreq(len(x), 1.0 / rate)[np.argmax(spec)])


def check_output(cell: Cell, out: Path) -> dict:
    """Frame count, 1 kHz FFT peak, container header, ID3 -> Vorbis
    comments, first FLAC frames decoding. Raises AssertionError."""
    expect = round(cell.seconds * cell.out_hz)
    res = {}
    if cell.output == "W":
        tag, ch, rate, bits, pcm = read_wav(out)
        assert (tag, ch, rate, bits) == (1 if cell.bits < 32 else 3, 2,
                                         cell.out_hz, cell.bits), \
            (tag, ch, rate, bits)
    elif cell.output == "S":
        raw = np.memmap(out, dtype=np.uint8, mode="r")
        assert raw.size % 6 == 0, raw.size
        pcm = _samples(raw, 24, 2, False)
    elif cell.output == "C":
        ch, frames, bits, comp, pcm = read_aifc(out)
        assert (ch, bits, comp) == (2, 32, b"fl32"), (ch, bits, comp)
        assert frames == len(pcm)
    else:
        from dsd2dxd_tpu.formats.flac_decode import decode_flac

        data = out.read_bytes()
        n_frames = -(-int(0.25 * cell.out_hz) // 8192) + 1
        st = decode_flac(data, max_frames=n_frames)
        assert (st.sample_rate, st.channels, st.bits_per_sample) == (
            cell.out_hz, 2, cell.bits), (st.sample_rate, st.channels,
                                         st.bits_per_sample)
        assert len(st.samples) >= min(expect, 8192), len(st.samples)
        if cell.id3:
            assert st.comments.get("TITLE") == ID3_TITLE, st.comments
            res["vorbis_title"] = st.comments["TITLE"]
        res["frames"] = st.total_samples
        pcm = st.samples
    frames = res.setdefault("frames", len(pcm))
    assert frames == expect, f"{frames} frames, expected {expect}"
    # a window past the stream head's filter warm-up
    n = min(len(pcm), cell.out_hz // 2)
    start = min(len(pcm) - n, cell.out_hz // 100)
    res["peak_hz"] = peak_hz(pcm[start:start + n, 0], cell.out_hz)
    assert abs(res["peak_hz"] - 1000.0) <= 2.0 * cell.out_hz / n, res
    return res


# ---------------------------------------------------------------------------
# Device-step timing
# ---------------------------------------------------------------------------


def device_step(conv, packed_shift=None, reps: int = 5) -> dict:
    """Median device time of the conversion's own compiled step (plus
    the device-side s24 pack when the drain uses it), over the same
    staged tiles, each call ended by block_until_ready."""
    import jax

    from dsd2dxd_tpu.pipeline.engine import _cached_step
    from dsd2dxd_tpu.pipeline.transfer import pack24_jitted

    chain_key, cfg = conv.step_config()
    step, make_state = _cached_step(chain_key, cfg)
    pack = pack24_jitted(packed_shift) if packed_shift is not None else None
    rng = np.random.default_rng(0)
    tiles = [jax.device_put(rng.integers(0, 256, (cfg.channels,
                                                  cfg.tile_bytes),
                                         dtype=np.uint8))
             for _ in range(2)]
    state = make_state()
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        out, peak, state = step(tiles[i % 2], state, i)
        if pack is not None:
            out = pack(out)
        jax.block_until_ready((out, peak))
        times.append(time.perf_counter() - t0)
    total = conv.source.info.data_bytes_per_channel
    return {"tile_bytes": cfg.tile_bytes,
            "tiles": -(-total // cfg.tile_bytes),
            "step_s": statistics.median(times[1:])}


def peak_bytes(device=None) -> int:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------------------
# The f64 oracle over a window across a tile boundary
# ---------------------------------------------------------------------------


def oracle_check(cell: Cell, work: Path, window_s: float = 1.0,
                 tile_target_bytes=None) -> dict:
    """Undithered 32-bit float and 24-bit output of the engine against
    the f64 upfirdn oracle, over `window_s` of output centred on the
    first tile boundary at the production tile size."""
    from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
    from dsd2dxd_tpu.formats.dsd_types import DitherType, OutputType
    from dsd2dxd_tpu.ops.phase import build_chain_plans, chain_tile_unit_bits
    from dsd2dxd_tpu.ops.resample import chain_reference
    from dsd2dxd_tpu.parallel.sharded import chain_halo_bits

    fcell = Cell(cell.name, "dsf", cell.rate_hz, 0.0, "W", 32, cell.out_hz,
                 "X")
    probe_src = write_fixture(fcell, tone_planes(cell.rate_hz, 0.01),
                              work / f"probe{cell.name}.dsf")
    probe = make_converter(fcell, probe_src, work)
    if tile_target_bytes:
        probe.tile_target_bytes = tile_target_bytes
    chain_key, cfg = probe.step_config()
    chain = get_chain(*chain_key)
    ratio = chain_ratio(chain)
    tile_frames = int(cfg.tile_bytes * 8 * ratio)
    win = int(window_s * cell.out_hz)
    w0 = max(tile_frames - win // 2, 0)
    w1 = w0 + win
    unit = chain_tile_unit_bits(build_chain_plans(chain))
    halo = chain_halo_bits(chain)
    # input bits [b0, b1): aligned to the tile unit, with the chain's
    # full history before w0
    b0 = max(0, (math.floor(w0 / ratio) - halo - unit) // unit * unit)
    b1 = -(-math.ceil(w1 / ratio) // unit) * unit
    planes = tone_planes(cell.rate_hz, (b1 + unit) / cell.rate_hz)
    src = write_fixture(fcell, planes, work / f"oracle{cell.name}.dsf")
    got = {}
    for bits in (32, 24):
        out_dir = work / f"oracle{cell.name}_{bits}"
        conv = make_converter(fcell, src, out_dir, dither=DitherType.NONE,
                              bits=bits, output=OutputType.WAV)
        if tile_target_bytes:
            conv.tile_target_bytes = tile_target_bytes
        assert conv.step_config()[1].tile_bytes == cfg.tile_bytes
        conv.do_conversion()
        got[bits] = np.array(read_wav(conv.output_path())[4][w0:w1])
    ref = chain_reference(chain, planes[:, b0 // 8:b1 // 8]).T
    k0 = int(b0 * ratio)
    ref = ref[w0 - k0:w1 - k0]
    assert len(ref) == len(got[32]) == len(got[24]) == win
    err = (got[32].astype(np.float64) - ref) / LSB24
    q = np.clip(np.round(ref / LSB24), -2 ** 23, 2 ** 23 - 1)
    diff = np.abs(got[24].astype(np.int64) - q.astype(np.int64))
    res = {"window": (w0, w1), "tile_frames": tile_frames,
           "rms_lsb": float(np.sqrt(np.mean(err ** 2))),
           "max_lsb": float(np.abs(err).max()),
           "int_max_diff": int(diff.max()),
           "int_share_over_1": float(np.mean(diff > 1))}
    assert res["rms_lsb"] < RMS_BOUND_LSB and res["max_lsb"] < MAX_BOUND_LSB \
        and res["int_max_diff"] <= INT_BOUND_LSB, res
    return res


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def run_cell(cell: Cell, work: Path, oracle_tile_target=None) -> dict:
    """Fixture, cold + warm conversion, output checks, device-step time,
    peak memory and (A, D, E) the oracle comparison; prints its lines."""
    src = build_fixture(cell, work)
    cold, _ = convert(cell, src, work / f"{cell.name}_cold")
    shutil.rmtree(work / f"{cell.name}_cold")
    warm, out = convert(cell, src, work / f"{cell.name}_warm")
    checks = check_output(cell, out)
    shutil.rmtree(work / f"{cell.name}_warm")
    packed = (cell.output in "WS" and cell.bits < 32 and cell.dither != "N")
    dev = device_step(make_converter(cell, src, work),
                      packed_shift=(4 if cell.bits == 20 else 0)
                      if packed else None)
    res = {"cell": cell.name, "compile_setup_s": cold - warm,
           "warm_s": warm, "xrt": cell.seconds / warm, **dev,
           "device_share": dev["tiles"] * dev["step_s"] / warm,
           "peak_bytes_in_use": peak_bytes(), **checks}
    print(f"cell {cell.name}: {describe(cell)} | compile+setup "
          f"{res['compile_setup_s']:.2f} s | warm e2e {warm:.3f} s = "
          f"{res['xrt']:.1f}x RT | tiles {dev['tiles']} x "
          f"{dev['tile_bytes']} B/ch | device step "
          f"{dev['step_s'] * 1e3:.3f} ms/tile | device share "
          f"{res['device_share']:.4f} | peak_bytes_in_use "
          f"{res['peak_bytes_in_use']} | frames {res['frames']}, "
          f"peak {res['peak_hz']:.1f} Hz", flush=True)
    if cell.oracle:
        o = oracle_check(cell, work, tile_target_bytes=oracle_tile_target)
        res["oracle"] = o
        print(f"cell {cell.name} oracle: frames {o['window'][0]}-"
              f"{o['window'][1]} across the tile boundary at "
              f"{o['tile_frames']}: 32f RMS {o['rms_lsb']:.4f} LSB24, max "
              f"{o['max_lsb']:.4f} LSB24 (bounds {RMS_BOUND_LSB}/"
              f"{MAX_BOUND_LSB:g}); 24-bit max |diff| {o['int_max_diff']} "
              f"LSB (bound {INT_BOUND_LSB}), "
              f"{o['int_share_over_1'] * 100:.3f}% of samples > 1 LSB",
              flush=True)
    res["src"] = src
    return res


def run_level_cell(cell_a: Cell, src: Path) -> dict:
    """Cell F: cell A's file through dsd_levels."""
    cold, _ = level_check(src, cell_a.out_hz)
    warm, db = level_check(src, cell_a.out_hz)
    assert -7.0 < db < -5.0, f"peak {db} dBFS for a -6 dBFS tone"
    from dsd2dxd_tpu.formats.dsd_types import DsdRate, Endianness, FmtType
    from dsd2dxd_tpu.pipeline.engine import Converter

    conv = Converter.new_level_check(
        output_rate=cell_a.out_hz, input_path=src, fmt=FmtType.PLANAR,
        endian=Endianness.LSB_FIRST, channels=2, block_size=4096,
        input_rate=DsdRate.DSD64)
    dev = device_step(conv)
    res = {"cell": "F", "compile_setup_s": cold - warm, "warm_s": warm,
           "xrt": cell_a.seconds / warm, "peak_dbfs": db, **dev,
           "device_share": dev["tiles"] * dev["step_s"] / warm,
           "peak_bytes_in_use": peak_bytes()}
    print(f"cell F: cell A's file -> dsd_levels -r {cell_a.out_hz} | "
          f"compile+setup {res['compile_setup_s']:.2f} s | warm e2e "
          f"{warm:.3f} s = {res['xrt']:.1f}x RT | tiles {dev['tiles']} | "
          f"device step {dev['step_s'] * 1e3:.3f} ms/tile | device share "
          f"{res['device_share']:.4f} | peak_bytes_in_use "
          f"{res['peak_bytes_in_use']} | peak {db:.2f} dBFS", flush=True)
    return res


def run_gpu_tests() -> int:
    """The gpu-marked tests, in this process and on this card."""
    import pytest

    # conftest.py defaults JAX_PLATFORMS to cpu; this process already
    # runs on the GPU, and the tests must see the same platform
    os.environ["JAX_PLATFORMS"] = "cuda"
    return int(pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                            str(REPO / "tests" / "test_gpu.py")]))


def four_cards(work: Path, devices=None, n_files: int = 8,
               batch_seconds: float = 60.0,
               long_seconds: float = 180.0) -> dict:
    """File batch across 4 cards vs device 0 alone (byte-identical), and
    one long DSD512 file sharded across 4 cards vs streamed on one
    (within 1e-4 past the warm-up). Returns peak_bytes_in_use per card."""
    import jax

    from dsd2dxd_tpu.cli.dsd2dxd import run
    from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
    from dsd2dxd_tpu.formats.dsd_types import DsdRate, FilterType
    from dsd2dxd_tpu.parallel.sharded import halo_bytes_for

    devs = devices or jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}"
    batch = work / "batch"
    batch.mkdir()
    files = []
    for i in range(n_files):
        rate = 2_822_400 if i % 2 == 0 else 5_644_800
        cell = Cell(f"b{i}", "dsf", rate, batch_seconds, "F", 24, 176_400,
                    "T")
        files.append(write_fixture(cell, tone_planes(rate, batch_seconds),
                                   batch / f"b{i}.dsf").resolve())
    args = ["-q", "-o", "F", "-b", "24", "-r", "176400"]
    for d in ("out4", "out4b"):
        (work / d).mkdir()
    rc = run(args + ["-p", str(work / "out4")] + [str(f) for f in files])
    assert rc == 0, rc
    t0 = time.perf_counter()
    rc = run(args + ["-p", str(work / "out4b")] + [str(f) for f in files])
    wall4 = time.perf_counter() - t0
    assert rc == 0, rc
    out1 = work / "out1"
    t0 = time.perf_counter()
    for i, f in enumerate(files):
        cell = Cell(f"b{i}", "dsf", 0, 0.0, "F", 24, 176_400, "T")
        make_converter(cell, f, out1, device=devs[0]).do_conversion()
    wall1 = time.perf_counter() - t0
    four = {p.name: p.read_bytes() for p in (work / "out4").rglob("*.flac")}
    one = {p.name: p.read_bytes() for p in out1.rglob("*.flac")}
    assert len(four) == len(one) == n_files, (len(four), len(one))
    same = sum(four[k] == one[k] for k in one)
    print(f"file batch: {n_files} x {batch_seconds:g} s DSD64/DSD128 -> "
          f"24-bit/176.4k FLAC | 4 cards {wall4:.3f} s "
          f"({n_files * batch_seconds / wall4:.1f}x RT), device 0 alone "
          f"{wall1:.3f} s ({n_files * batch_seconds / wall1:.1f}x RT) | "
          f"byte-identical {same}/{n_files}", flush=True)
    assert same == n_files
    shutil.rmtree(batch)

    cell = Cell("long", "dsf", 22_579_200, long_seconds, "W", 32, 352_800,
                "X")
    src = build_fixture(cell, work)
    outs, walls = {}, {}
    for mode in ("single", "sharded"):
        if mode == "sharded":
            os.environ["DSD2DXD_SHARD_STREAM"] = "1"
        try:
            conv = make_converter(cell, src, work / mode,
                                  device=devs[0] if mode == "single" else None)
            t0 = time.perf_counter()
            conv.do_conversion()
            walls[mode] = time.perf_counter() - t0
        finally:
            os.environ.pop("DSD2DXD_SHARD_STREAM", None)
        outs[mode] = read_wav(conv.output_path())[4]
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD512, 352_800)
    ratio = chain_ratio(chain)
    skip = int(halo_bytes_for(chain) * 8 * ratio) + 1
    a, b = outs["single"], outs["sharded"]
    assert a.shape == b.shape == (round(long_seconds * 352_800), 2)
    step = 1 << 22
    err = max(float(np.abs(a[i:i + step] - b[i:i + step]).max())
              for i in range(skip, len(a), step))
    peaks = [peak_bytes(d) for d in devs]
    print(f"long file: DSD512 {long_seconds:g} s -> 32f/352.8k WAV, "
          f"undithered | sharded over 4 cards {walls['sharded']:.3f} s "
          f"({long_seconds / walls['sharded']:.1f}x RT), streamed on one "
          f"{walls['single']:.3f} s ({long_seconds / walls['single']:.1f}x "
          f"RT) | max |diff| past frame {skip}: {err:.3e} (bound 1e-4)",
          flush=True)
    print(f"peak_bytes_in_use per card: {peaks}", flush=True)
    assert err < 1e-4, err
    return {"batch_identical": same, "long_max_diff": err, "peaks": peaks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)
    if not (REPO / "dsd2dxd_tpu").is_dir():
        print("chip_smoke.py runs from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from dsd2dxd_tpu.native import lib as native
    from dsd2dxd_tpu.utils.device import card_info, enable_compile_cache

    cache = enable_compile_cache()
    print(card_info(), flush=True)
    print(f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
          f"{cache or os.environ.get('JAX_COMPILATION_CACHE_DIR')}",
          flush=True)
    if native is None:
        print("the native library did not load (g++ build of "
              "dsd2dxd_tpu/native/src)", file=sys.stderr)
        return 1
    work = REPO / ".smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    failures = []
    t_start = time.perf_counter()
    try:
        if args.four_cards:
            try:
                peaks = four_cards(work)["peaks"]
                if not all(p > 0 for p in peaks):
                    failures.append(f"a card did no work: peaks {peaks}")
            except Exception as e:  # noqa: BLE001 - reported, exit 1
                failures.append(f"four cards: {type(e).__name__}: {e}")
        else:
            done = {}
            for cell in CELLS:
                try:
                    done[cell.name] = run_cell(cell, work)
                except Exception as e:  # noqa: BLE001 - reported, exit 1
                    failures.append(f"cell {cell.name}: "
                                    f"{type(e).__name__}: {e}")
            try:
                if "A" not in done:
                    raise RuntimeError("cell A failed, no file to scan")
                run_level_cell(CELLS[-1], done["A"]["src"])
            except Exception as e:  # noqa: BLE001 - reported, exit 1
                failures.append(f"cell F: {type(e).__name__}: {e}")
            rc = run_gpu_tests()
            if rc != 0:
                failures.append(f"gpu-marked tests: pytest exited {rc}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        for f in failures:
            print(f"FAILED {f}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
