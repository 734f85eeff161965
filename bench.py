"""Headline benchmark: sustained conversion throughput as a real-time
multiple (xRT) on the BASELINE.md config-1 path — DSD64 stereo -> 24-bit
352.8 kHz PCM (Equiripple bank, TPDF dither) — on a GPU.

Default mode measures the device step the engine runs (ops/phase.py):
1-bit unpack -> phase-major FIR cascade -> level -> TPDF dither ->
24-bit quantize -> peak, with streaming filter state carried across
tiles. Inputs are staged on the device before the timed region; every
tile's PCM is folded into a digest, and the run ends with
`block_until_ready` on the digests (tools/timing.py).

`--e2e` times the full loop instead: per-tile upload + device step +
on-device s24 packing + copy back and interleave on the host, with the
drain of tile i-1 overlapping tile i as in the engine.

`--config N` (1-5) runs BASELINE.md's end-to-end workload N through the
real engine/CLI — container parse -> upload -> device DSP -> copy back
-> host dither/pack/FLAC -> file writes — on cached synthesized
fixtures.

Every result line is one JSON object: {"metric", "value", "unit",
"vs_baseline", "device"}. vs_baseline is against BASELINE.md's
1000x-real-time north star; "device" names the platform, device kind
and count as JAX reports them, and the card's name and power limit
from nvidia-smi. Without a GPU the script prints no result and exits
with code 2.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

_CACHE = Path(__file__).parent / "bench_cache"

def _tone_planes(rate_hz: int, seconds: float, channels: int = 2):
    """Cached DSM tone synthesis (the host delta-sigma loop runs ~0.25x
    real-time): synthesize one second once, then tile it — the modulator
    is near-periodic at 1 kHz so seams are inaudible and irrelevant to
    throughput."""
    _CACHE.mkdir(exist_ok=True)
    base = _CACHE / f"tone_{rate_hz}_{channels}.npy"
    if base.exists():
        one = np.load(base)
    else:
        from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

        one = synth_tone_dsd(1000.0, 1.0, rate_hz, amplitude=0.5,
                             channels=channels)
        np.save(base, one)
    reps = max(1, int(round(seconds)))
    return np.tile(one, (1, reps))


def _fixture_dsf(name: str, rate_hz: int, seconds: float,
                 id3: bytes | None = None) -> Path:
    from dsd2dxd_tpu.formats.dsf import write_dsf

    path = _CACHE / name
    if not path.exists():
        write_dsf(path, _tone_planes(rate_hz, seconds), rate_hz,
                  lsb_first=True, id3=id3)
    return path


class _CountingOut(io.RawIOBase):
    """Byte-counting stdout sink for the raw-stdout config."""

    def __init__(self):
        self.n = 0

    def write(self, b) -> int:  # type: ignore[override]
        self.n += len(b)
        return len(b)

    def flush(self) -> None:
        pass


def _require_gpu() -> dict:
    """The device record every result line carries; exits with code 2,
    printing no result, unless JAX's default backend is a GPU."""
    import jax

    from dsd2dxd_tpu.utils.device import card_info

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}. No measurement taken.",
              file=sys.stderr)
        raise SystemExit(2)
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def main(device: dict, e2e: bool = False) -> None:
    import jax

    from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
    from dsd2dxd_tpu.formats.dsd_types import DitherType, DsdRate, FilterType
    from dsd2dxd_tpu.ops.resample import StepConfig
    from dsd2dxd_tpu.pipeline.engine import _cached_step
    from dsd2dxd_tpu.pipeline.transfer import pack24_jitted, unpack24_host

    in_hz = DsdRate.DSD64.hz
    tile_bytes = 16 * 1024 * 1024  # 16 MiB/ch per tile (~47.6 s of DSD64)
    cfg = StepConfig(channels=2, tile_bytes=tile_bytes, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    chain_key = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    step, make_state = _cached_step(chain_key, cfg)
    sys.path.insert(0, str(Path(__file__).parent / "tools"))
    import timing

    digest = timing.make_digest()
    rng = np.random.default_rng(0)
    n_tiles = 8
    n_frames = int(tile_bytes * 8 * chain_ratio(get_chain(*chain_key)))
    host_tiles = [rng.integers(0, 256, size=(2, tile_bytes), dtype=np.uint8)
                  for _ in range(n_tiles)]
    pack = pack24_jitted(0)

    def run_e2e() -> float:
        """Per-tile upload + device step + device pack + copy back and
        host interleave, one-deep pipelined like the engine's drain."""
        state = make_state()
        t0 = time.perf_counter()
        pending = None  # tile i-1's packed output, drained while i runs
        for i in range(n_tiles):
            out, _peak, state = step(jax.device_put(host_tiles[i]), state, i)
            this = pack(out)
            if pending is not None:
                unpack24_host(np.asarray(pending)[:, :n_frames * 2])
            pending = this
        unpack24_host(np.asarray(pending)[:, :n_frames * 2])
        return time.perf_counter() - t0

    audio_seconds = n_tiles * tile_bytes * 8 / in_hz
    if e2e:
        run_e2e()  # compile + warmup
        xrt = audio_seconds / timing.min_of(run_e2e, 3)
    else:
        staged = [jax.device_put(t) for t in host_tiles]
        jax.block_until_ready(staged)
        timing.timed_run(step, make_state, staged, digest)  # compile
        xrt = audio_seconds / timing.min_of(
            lambda: timing.timed_run(step, make_state, staged, digest), 3)
    name = "xrt_dsd64_stereo_to_352k8_24bit" + ("_e2e" if e2e
                                                else "_device")
    _emit(name, audio_seconds, audio_seconds / xrt, device)


def _emit(metric: str, audio_s: float, wall_s: float, device: dict) -> None:
    xrt = audio_s / wall_s
    print(json.dumps({
        "metric": metric,
        "value": round(xrt, 1),
        "unit": "x_realtime",
        "vs_baseline": round(xrt / 1000.0, 3),
        "device": device,
    }))


def _convert(src: Path, out_dir: Path, **kw) -> float:
    """One engine conversion; returns wall seconds."""
    from dsd2dxd_tpu.pipeline.engine import Converter

    from dsd2dxd_tpu.formats.dsd_types import FilterType

    out_dir.mkdir(parents=True, exist_ok=True)
    kw.setdefault("filt", FilterType.EQUIRIPPLE)
    conv = Converter.from_container(
        out_dir=out_dir, append_rate=False, base_dir=src.parent,
        input_path=src, level_db=0.0, **kw)
    t0 = time.perf_counter()
    conv.do_conversion()
    return time.perf_counter() - t0


def config_n(n: int, device: dict) -> None:
    """BASELINE.md end-to-end config N (module docstring)."""
    import tempfile

    from dsd2dxd_tpu.formats.dsd_types import DitherType, OutputType

    tmp = Path(tempfile.mkdtemp(prefix="dsd2dxd_bench_"))
    if n == 1:
        # DSD64 planar .dsf -> 24-bit 352.8k WAV, TPDF
        src = _fixture_dsf("bench64.dsf", 2_822_400, 24.0)
        audio = 24.0
        _convert(src, tmp / "w", bit_depth=24, output=OutputType.WAV,
                 output_rate=352800, dither=DitherType.TPDF)  # warm compile
        wall = _convert(src, tmp / "w2", bit_depth=24, output=OutputType.WAV,
                        output_rate=352800, dither=DitherType.TPDF)
        _emit("xrt_cfg1_dsd64_dsf_to_352k8_24bit_wav_e2e", audio, wall,
              device)
    elif n == 2:
        # raw interleaved DSD64 stdin -> raw s24le 176.4k stdout
        from dsd2dxd_tpu.formats.dsd_types import (
            DsdRate,
            Endianness,
            FilterType,
            FmtType,
        )
        from dsd2dxd_tpu.pipeline.engine import Converter

        planes = _tone_planes(2_822_400, 24.0)
        audio = planes.shape[1] * 8 / 2_822_400
        raw = _CACHE / "bench64_i.dsd"
        if not raw.exists():
            # byte-interleaved MSB-first, the 1kHz_stereo_i.dsd layout
            inter = np.empty((planes.shape[1] * 2,), dtype=np.uint8)
            inter[0::2] = planes[0]
            inter[1::2] = planes[1]
            raw.write_bytes(inter.tobytes())

        def run_once() -> float:
            conv = Converter.new(
                bit_depth=24, output=OutputType.STDOUT, level_db=0.0,
                output_rate=176400, out_dir=None, dither=DitherType.TPDF,
                fmt=FmtType.INTERLEAVED, endian=Endianness.MSB_FIRST,
                input_rate=DsdRate.DSD64, block_size=4096, channels=2,
                filt=FilterType.EQUIRIPPLE, append_rate=False,
                base_dir=tmp, input_path=raw)
            sink = _CountingOut()
            real = sys.stdout
            sys.stdout = type("S", (), {"buffer": sink})()  # engine writes here
            try:
                t0 = time.perf_counter()
                conv.do_conversion()
                dt = time.perf_counter() - t0
            finally:
                sys.stdout = real
            assert sink.n > 0
            return dt

        run_once()
        _emit("xrt_cfg2_raw_i_dsd64_to_s24le_176k4_stdout_e2e", audio,
              run_once(), device)
    elif n == 3:
        # DSD128 .dsf -> 88.2k FLAC, 20-bit, NJAD
        src = _fixture_dsf("bench128.dsf", 5_644_800, 16.0)
        audio = 16.0
        _convert(src, tmp / "w", bit_depth=20, output=OutputType.FLAC,
                 output_rate=88200, dither=DitherType.NJAD)
        wall = _convert(src, tmp / "w2", bit_depth=20, output=OutputType.FLAC,
                        output_rate=88200, dither=DitherType.NJAD)
        _emit("xrt_cfg3_dsd128_dsf_to_88k2_flac_20bit_njad_e2e", audio,
              wall, device)
    elif n == 4:
        # DSD256 -> 32f AIFF at a 48k-multiple rate, plus DSD512 -> 352.8k
        # (the only valid DSD512 cell); combined wall clock
        src256 = _fixture_dsf("bench256.dsf", 11_289_600, 8.0)
        src512 = _fixture_dsf("bench512.dsf", 22_579_200, 8.0)
        # 32-bit float rides in AIFC (AIFF has no float sample type)
        kw256 = dict(bit_depth=32, output=OutputType.AIFC, output_rate=384000,
                     dither=DitherType.FPD)
        kw512 = dict(bit_depth=32, output=OutputType.AIFC, output_rate=352800,
                     dither=DitherType.FPD)
        _convert(src256, tmp / "w", **kw256)
        _convert(src512, tmp / "w", **kw512)
        wall = (_convert(src256, tmp / "w2", **kw256)
                + _convert(src512, tmp / "w2", **kw512))
        _emit("xrt_cfg4_dsd256_384k_dsd512_352k8_f32_aiff_e2e", 16.0, wall,
              device)
    elif n == 5:
        # recursive batch -> 24-bit FLAC with ID3 copy, multi-stream
        from dsd2dxd_tpu.cli.dsd2dxd import run as cli_run
        from dsd2dxd_tpu.formats.dff import write_dff
        from dsd2dxd_tpu.formats.id3 import Id3Frame, Id3Tag

        tag = Id3Tag(frames=[Id3Frame.text_frame("TIT2", "1kHz Test Tone"),
                             Id3Frame.text_frame("TPE1", "bench"),
                             Id3Frame.text_frame("TALB", "Bench Tones")])
        batch = _CACHE / "batch"
        (batch / "sub").mkdir(parents=True, exist_ok=True)
        _fixture_dsf("batch/a64.dsf", 2_822_400, 12.0, id3=tag.to_bytes())
        _fixture_dsf("batch/sub/b64.dsf", 2_822_400, 12.0)
        dff = batch / "c128.dff"
        if not dff.exists():
            write_dff(dff, _tone_planes(5_644_800, 8.0), 5_644_800,
                      id3=tag.to_bytes())
        audio = 12.0 + 12.0 + 8.0
        for sub in ("w", "w2"):
            out = tmp / sub
            out.mkdir()
            t0 = time.perf_counter()
            rc = cli_run(["-R", "-o", "f", "-q", "-p", str(out), str(batch)])
            wall = time.perf_counter() - t0
            assert rc == 0
            assert len(list(out.rglob("*.flac"))) == 3
        _emit("xrt_cfg5_recursive_batch_flac_id3_e2e", audio, wall, device)
    else:
        raise SystemExit(f"unknown config {n}")


if __name__ == "__main__":
    from dsd2dxd_tpu.utils.device import enable_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--config", type=int, default=None,
                    help="run BASELINE.md end-to-end config 1-5")
    a = ap.parse_args()
    enable_compile_cache()  # reuse XLA compiles across bench runs
    dev = _require_gpu()
    if a.config is not None:
        config_n(a.config, dev)
    else:
        main(dev, e2e=a.e2e)
