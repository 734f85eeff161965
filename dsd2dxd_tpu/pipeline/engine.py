"""Conversion engine — the device-side replacement for the reference's
``rdsd2pcm::Rdsd2Pcm``.

API mirrors the reference engine surface as reconstructed from its call
sites (reference src/main.rs:27-31, 325-345, 361-393, 429;
src/bin/dsd_levels/main.rs:214-223, 252): ``Converter.new`` /
``Converter.from_container`` / ``Converter.new_level_check`` construct;
``do_conversion`` / ``check_level`` run; ``file_name`` names.

Execution model (contrast with the reference's scalar 4096-byte block
loop, SURVEY.md §3.5): the host reader normalizes the stream to
per-channel MSB-first byte planes; multi-megabyte tiles flow through one
jitted XLA step (unpack -> FIR chain -> level -> dither -> quantize ->
peak) with per-stage history carried on device; a triple-overlap
pipeline runs read/upload of tile t+1, device compute of tile t, and
D2H/pack/write of tile t-1 concurrently (drain on a single ordered
worker thread). Compiled steps are cached per configuration and shared
across files.
"""

from __future__ import annotations

import math
import sys
from functools import lru_cache
from pathlib import Path
from typing import BinaryIO, Callable, Optional

import numpy as np

from dsd2dxd_tpu.formats.discover import build_output_path
from dsd2dxd_tpu.formats.dsd_types import (
    ONE_HUNDRED_PERCENT,
    DitherType,
    DsdFileFormat,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
    ProgressUpdate,
    check_filter_choice,
)
from dsd2dxd_tpu.formats.source import DsdSource, open_raw_file, raw_source
from dsd2dxd_tpu.utils.errors import CancelledError, ConfigError

ProgressFn = Callable[[ProgressUpdate], None]
CancelFn = Callable[[], bool]

_DEFAULT_TILE_TARGET = 4 * 1024 * 1024  # DSD bytes per channel per tile

# Outstanding drains in the triple-overlap pipeline (read/upload of
# t+1 || compute of t || D2H+write of t-1). 0 serializes the drain
# after each dispatch — the pre-round-3 behavior, kept settable so the
# overlap gain stays measurable A/B (bench.py --config).
MAX_PENDING_DRAINS = 2


def _file_seed(path: Optional[Path]) -> int:
    """Per-file dither seed base: derived from the input path so two
    files never share a noise stream, while the same file converts
    reproducibly across runs (the reference draws fresh `rand` entropy
    per run — we trade that for auditability). DSD2DXD_SEED shifts the
    whole noise universe, e.g. to produce an independent second take."""
    import hashlib
    import os

    env = os.environ.get("DSD2DXD_SEED", "")
    ident = str(path) if path is not None else "stdin"
    h = hashlib.sha256(f"{env}:{ident}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x3FFFFFFF


def _tile_bytes_for(chain, target_bytes: int) -> int:
    """Tile size (bytes/channel) aligned so every stage of the phase-major
    pipeline keeps integral lane counts (ops/phase.py)."""
    from dsd2dxd_tpu.ops.phase import build_chain_plans, chain_tile_unit_bits

    unit_bits = chain_tile_unit_bits(build_chain_plans(chain))
    target_bits = target_bytes * 8
    n_units = max(1, -(-target_bits // unit_bits))
    return n_units * unit_bits // 8


@lru_cache(maxsize=32)
def _cached_step(chain_key, cfg):
    """(step(x, state, tile_idx) -> (pcm, peak, state), make_state()) for
    one (chain, StepConfig): the jitted phase-major step (ops/phase.py),
    shared by every file with the same configuration."""
    import jax

    from dsd2dxd_tpu.filters.design import get_chain
    from dsd2dxd_tpu.ops.phase import (
        build_chain_plans,
        init_phase_hists,
        make_phase_step,
    )

    chain = get_chain(*chain_key)
    pstep = make_phase_step(chain, cfg)
    base_key = jax.random.PRNGKey(0x5D5D)

    def step(x, state, tile_idx):
        return pstep(x, state, jax.random.fold_in(base_key, tile_idx))

    def make_state():
        return init_phase_hists(build_chain_plans(chain), cfg.channels)

    return step, make_state


class Converter:
    """One conversion (or level-check) job. Mirrors ``Rdsd2Pcm``."""

    def __init__(self, *, source: DsdSource, input_path: Optional[Path],
                 bit_depth: int, output: OutputType, level_db: float,
                 output_rate: int, out_dir: Optional[Path],
                 dither: DitherType, filt: FilterType, append_rate: bool,
                 base_dir: Optional[Path], level_check_only: bool = False,
                 tile_target_bytes: Optional[int] = None, device=None):
        info = source.info
        check_filter_choice(filt, info.rate, output_rate)
        if bit_depth not in (16, 20, 24, 32):
            raise ConfigError(f"Invalid bit depth: {bit_depth}")
        if output is OutputType.FLAC and bit_depth == 32:
            raise ConfigError("FLAC output supports integer depths only")
        if dither is DitherType.NJAD and bit_depth == 32:
            raise ConfigError(
                "NJAD dither quantizes to integer depths (use -d F for "
                "32-bit float output)")
        self.source = source
        self.input_path = Path(input_path) if input_path else None
        self.bit_depth = bit_depth
        self.output = output
        self.level_db = float(level_db)
        self.output_rate = int(output_rate)
        self.out_dir = Path(out_dir) if out_dir else None
        self.dither = dither
        self.filt = filt
        self.append_rate = append_rate
        self.base_dir = Path(base_dir) if base_dir else None
        self.level_check_only = level_check_only
        # file-level data parallelism: pin this conversion's pipeline to
        # one device; the CLI round-robins a batch across jax.devices()
        # (the device analog of the reference's one-file-per-Rayon-thread,
        # src/main.rs:279-297)
        self.device = device
        # resolved at call time so tests can shrink the module default
        self.tile_target_bytes = (tile_target_bytes if tile_target_bytes
                                  else _DEFAULT_TILE_TARGET)
        # (mode 16|24, shift, big_endian, write_packed) device-pack drain
        self._packed = None
        # does the device step emit float frames? (set in _run; gates the
        # partial-final-tile peak recompute in _drain)
        self._float_out = False
        self._out_path = self._build_output_path()

    # -- construction mirroring the reference API ---------------------------

    @classmethod
    def new(cls, bit_depth: int, output: OutputType, level_db: float,
            output_rate: int, out_dir: Optional[Path], dither: DitherType,
            fmt: FmtType, endian: Endianness, input_rate: DsdRate,
            block_size: int, channels: int, filt: FilterType,
            append_rate: bool, base_dir: Path,
            input_path: Optional[Path], device=None) -> "Converter":
        """Raw/explicit-config constructor (stdin or raw .dsd file) —
        parameter-for-parameter with the reference
        (src/main.rs:325-343)."""
        if input_path is None:
            src = raw_source(sys.stdin.buffer, channels, input_rate, fmt,
                             endian, block_size)
        else:
            src = open_raw_file(input_path, channels, input_rate, fmt,
                                endian, block_size)
        return cls(source=src, input_path=input_path, bit_depth=bit_depth,
                   output=output, level_db=level_db, output_rate=output_rate,
                   out_dir=out_dir, dither=dither, filt=filt,
                   append_rate=append_rate, base_dir=base_dir, device=device)

    @classmethod
    def from_container(cls, bit_depth: int, output: OutputType,
                       level_db: float, output_rate: int,
                       out_dir: Optional[Path], dither: DitherType,
                       filt: FilterType, append_rate: bool, base_dir: Path,
                       input_path: Path, device=None) -> "Converter":
        """Container path (.dsf/.dff): fmt/endian/rate/block-size/channels
        come from the container, overriding any CLI flags (reference
        src/main.rs:361-374; README.md:102-106)."""
        src = open_container(input_path)
        return cls(source=src, input_path=input_path, bit_depth=bit_depth,
                   output=output, level_db=level_db, output_rate=output_rate,
                   out_dir=out_dir, dither=dither, filt=filt,
                   append_rate=append_rate, base_dir=base_dir, device=device)

    @classmethod
    def new_level_check(cls, output_rate: int, input_path: Optional[Path],
                        fmt: FmtType, endian: Endianness, channels: int,
                        block_size: int, input_rate: DsdRate) -> "Converter":
        """Peak-analysis constructor (reference
        src/bin/dsd_levels/main.rs:214-222). Container inputs take their
        parameters from metadata, raw inputs from the arguments."""
        if input_path is not None and DsdFileFormat.from_path(input_path).is_container():
            src = open_container(input_path)
        elif input_path is None:
            src = raw_source(sys.stdin.buffer, channels, input_rate, fmt,
                             endian, block_size)
        else:
            src = open_raw_file(input_path, channels, input_rate, fmt,
                                endian, block_size)
        return cls(source=src, input_path=input_path, bit_depth=32,
                   output=OutputType.STDOUT, level_db=0.0,
                   output_rate=output_rate, out_dir=None,
                   dither=DitherType.NONE, filt=FilterType.EQUIRIPPLE,
                   append_rate=False, base_dir=None, level_check_only=True)

    # -- naming -------------------------------------------------------------

    def file_name(self) -> str:
        """Display name (reference src/main.rs:398)."""
        return self.input_path.name if self.input_path else "stdin"

    def output_path(self) -> Optional[Path]:
        return self._out_path

    def _build_output_path(self) -> Optional[Path]:
        if self.output is OutputType.STDOUT or self.level_check_only:
            return None
        return build_output_path(
            self.input_path,
            self.base_dir if self.base_dir is not None else Path.cwd(),
            self.out_dir, self.output, self.output_rate, self.append_rate,
        )

    # -- the conversion loop ------------------------------------------------

    def _make_writer(self, f: BinaryIO, id3: Optional[bytes]):
        from dsd2dxd_tpu.containers.aiff import AiffWriter
        from dsd2dxd_tpu.containers.wav import WavWriter

        ch = self.source.info.channels
        if self.output is OutputType.WAV:
            return WavWriter(f, ch, self.output_rate, self.bit_depth, id3=id3)
        if self.output is OutputType.AIFF:
            return AiffWriter(f, ch, self.output_rate, self.bit_depth, id3=id3)
        if self.output is OutputType.AIFC:
            return AiffWriter(f, ch, self.output_rate, self.bit_depth,
                              aifc=True, id3=id3)
        if self.output is OutputType.FLAC:
            from dsd2dxd_tpu.containers.flac import FlacWriter

            return FlacWriter(f, ch, self.output_rate, self.bit_depth, id3=id3)
        raise ConfigError(f"No writer for {self.output}")

    def step_config(self):
        """(chain_key, StepConfig) of the device step this conversion
        runs: the tile size and the effective depth and dither."""
        from dsd2dxd_tpu.filters.design import get_chain
        from dsd2dxd_tpu.ops.resample import StepConfig

        info = self.source.info
        chain_key = (self.filt, info.rate, self.output_rate)
        # NJAD is a sequential host-side requantizer (native/src/njad.cc):
        # the device step emits float PCM, the sink quantizes.
        float_out = (self.level_check_only
                     or self.dither is DitherType.NJAD
                     or self.bit_depth == 32)
        # Scale tiles with the input rate (constant audio seconds per
        # tile, enough work per dispatch to amortize fixed per-step
        # costs at DSD256/512 rates), capped at 4x: a stereo DSD512
        # conversion at the cap (16 MiB/ch tiles) peaks at 2.1 GB of
        # device memory on an H100 (peak_bytes_in_use, chip_smoke.py
        # cell E), so a card holds many concurrent file pipelines.
        tile_bytes = _tile_bytes_for(
            get_chain(*chain_key),
            self.tile_target_bytes * min(int(info.rate), 4))
        cfg = StepConfig(
            channels=info.channels,
            tile_bytes=tile_bytes,
            bit_depth=32 if float_out else self.bit_depth,
            dither=(DitherType.NONE
                    if self.level_check_only or self.dither is DitherType.NJAD
                    else self.dither),
            level_db=self.level_db,
        )
        return chain_key, cfg

    def _run(self, cancel: Optional[CancelFn], progress: Optional[ProgressFn],
             sink: Optional[Callable[[np.ndarray], None]]) -> float:
        """Shared tile loop. Returns the stream peak (linear, post-level).

        ``sink`` receives (frames, channels) int32/float32 tiles; None for
        level-check mode.
        """
        import contextlib
        import os
        import time

        from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
        from dsd2dxd_tpu.utils.logging import TRACE, get_logger

        # Device-profiling hook (SURVEY.md §5 tracing row): set
        # DSD2DXD_PROFILE_DIR to capture a jax.profiler trace per stream.
        prof_dir = os.environ.get("DSD2DXD_PROFILE_DIR")
        if prof_dir:
            import jax

            prof_ctx = jax.profiler.trace(prof_dir)
        else:
            prof_ctx = contextlib.nullcontext()
        with prof_ctx:
            t_start = time.perf_counter()
            info = self.source.info
            chain_key, cfg = self.step_config()
            tile_bytes = cfg.tile_bytes
            chain = get_chain(*chain_key)
            ratio = chain_ratio(chain)
            self._float_out = cfg.bit_depth == 32
            from dsd2dxd_tpu.utils.device import stream_mesh

            mesh = stream_mesh()
            if mesh is not None:
                return self._run_tile_sharded(mesh, chain, ratio, cfg,
                                              cancel, progress, sink)
            step, make_state = _cached_step(chain_key, cfg)
            import jax

            # one placement: device=None lands on the default device
            state = jax.device_put(make_state(), self.device)
            seed_base = _file_seed(self.input_path)

            total_bytes = info.data_bytes_per_channel  # None for unbounded stdin
            consumed = 0
            valid_bits = 0
            emitted = 0
            tile_idx = 0
            # Triple-overlap pipeline: the main
            # thread reads tile t+1 and uploads/dispatches it while the
            # device computes tile t and a single drain worker performs
            # the (blocking) D2H + host pack/write of tile t-1. The
            # worker is one thread so writes stay in stream order; the
            # deque bounds device-resident output tiles at 3.
            import collections
            from concurrent.futures import ThreadPoolExecutor

            peak_box = [0.0]
            drain_err: list = []

            def do_drain(pending):
                # A failed write (disk full, sink error) must stop the
                # LATER queued drains too: they run on the same worker
                # after the failure and would append frames past the
                # gap, turning a clean truncation into a file with a
                # hole. First popleft().result() re-raises the original.
                if drain_err:
                    return
                try:
                    peak_box[0] = self._drain(pending, sink, peak_box[0])
                except BaseException as e:
                    drain_err.append(e)
                    raise

            drains: collections.deque = collections.deque()
            pool = ThreadPoolExecutor(max_workers=1)
            try:
                while True:
                    if cancel is not None and cancel():
                        raise CancelledError("Conversion canceled")
                    planes = self.source.read(tile_bytes)
                    if planes is None:
                        break
                    got = planes.shape[1]
                    consumed += got
                    valid_bits += got * 8
                    if info.sample_count is not None:
                        # The final byte of a stream whose sample_count is
                        # not a multiple of 8 carries up-to-7 undefined
                        # padding bits; trim at the exact bit count so they
                        # are never converted as signal (or counted toward
                        # the peak).
                        valid_bits = min(valid_bits, info.sample_count)
                    if got < tile_bytes:
                        pad = np.full((info.channels, tile_bytes - got), 0x69,
                                      dtype=np.uint8)  # DSD idle, not DC
                        planes = np.concatenate([planes, pad], axis=1)
                    n_total = int(valid_bits * ratio)
                    n_valid = n_total - emitted
                    emitted = n_total
                    out, tile_peak, state = step(
                        jax.device_put(planes, self.device),
                        state, (seed_base + tile_idx) & 0x7FFFFFFF)
                    tile_idx += 1
                    drains.append(pool.submit(do_drain,
                                              (out, tile_peak, n_valid)))
                    while len(drains) > MAX_PENDING_DRAINS:
                        drains.popleft().result()
                    if progress is not None and total_bytes:
                        pct = min(100.0 * consumed / total_bytes,
                                  ONE_HUNDRED_PERCENT)
                        progress(ProgressUpdate(percent=pct))
                while drains:
                    drains.popleft().result()
            finally:
                pool.shutdown(wait=True)
            peak = peak_box[0]
            if progress is not None:
                progress(ProgressUpdate(percent=ONE_HUNDRED_PERCENT))
            # per-file throughput trace (the reference reports only batch
            # wall-clock — SURVEY.md §5 tracing row asks for per-stream xRT)
            elapsed = time.perf_counter() - t_start
            audio_s = valid_bits / info.rate.hz
            if elapsed > 0 and audio_s > 0:
                get_logger().log(
                    TRACE,
                    f"{self.file_name()}: {audio_s:.1f}s audio in {elapsed:.2f}s "
                    f"({audio_s / elapsed:.0f}x real-time, "
                    f"{consumed * info.channels / elapsed / 2**20:.1f} MiB/s DSD in)")
            return peak

    def _run_tile_sharded(self, mesh, chain, ratio, cfg, cancel, progress,
                          sink) -> float:
        """Sequence-parallel mode (DSD2DXD_SHARD_STREAM=1): split ONE
        stream into overlap-save tiles converted across every device of
        the mesh (SURVEY.md §5 long-context row; parallel/sharded.py).
        Streams in bounded macro-chunks of n_devices x tile, so host RSS
        stays O(devices x tile) and progress is real."""
        from dsd2dxd_tpu.formats.dsd_types import ONE_HUNDRED_PERCENT
        from dsd2dxd_tpu.parallel.sharded import convert_stream_tiled_chunked

        import jax

        info = self.source.info
        peak = convert_stream_tiled_chunked(
            self.source.read, chain, cfg, mesh, sink,
            key=jax.random.PRNGKey(_file_seed(self.input_path)),
            cancel=cancel, progress=progress,
            total_bytes=info.data_bytes_per_channel,
            max_bits=info.sample_count)
        if progress is not None:
            progress(ProgressUpdate(percent=ONE_HUNDRED_PERCENT))
        return float(peak)

    def _drain(self, pending, sink, peak: float) -> float:
        out, tile_peak, n_valid = pending
        tile_peak = float(tile_peak)
        # The step's tile peak covers every emitted frame of the FIXED
        # tile shape — in a partial final tile that includes frames past
        # n_valid, where the signal->idle-pad filter transient can ring
        # above the true stream peak (the sharded path masks these via
        # finish_tile's n_valid). Only check_level consumes the peak and
        # it runs the float frames-major path, so recompute the
        # valid-prefix max exactly on host there; one extra D2H on the
        # final tile of a file, full tiles keep the free device peak.
        # (gated on float output: an int-frames sink here — e.g. FLAC —
        # would replace the normalized float peak with a raw int32
        # magnitude, ~2^23 too large at 24-bit)
        if self._float_out and n_valid < np.shape(out)[0]:
            tile_peak = (float(np.abs(np.asarray(out)[:n_valid]).max())
                         if n_valid > 0 else 0.0)
        peak = max(peak, tile_peak)
        # Device ops below always see the FULL fixed tile shape and the
        # valid prefix is sliced on host: slicing on device would trace
        # a fresh program per distinct final-partial-tile length — one
        # compile per file in a batch.
        ch = self.source.info.channels
        if sink is not None and n_valid > 0:
            if self._packed is not None:
                # 16/20/24-bit drain: pack ON DEVICE (int16, or 3 byte-
                # planes for 24-bit) so the wire carries 2-3 bytes/sample
                # instead of 4; byte-order fixup on host
                # (SURVEY.md §2.3 item 3)
                from dsd2dxd_tpu.pipeline.transfer import (
                    pack16_jitted,
                    pack24_jitted,
                    unpack16_host,
                    unpack24_host,
                )

                mode, shift, big_endian, write_packed = self._packed
                if mode == 16:
                    v = np.asarray(pack16_jitted()(out))[:n_valid * ch]
                    write_packed(unpack16_host(v, big_endian))
                else:
                    rows = np.asarray(
                        pack24_jitted(shift)(out))[:, :n_valid * ch]
                    write_packed(unpack24_host(rows, big_endian))
            else:
                sink(np.asarray(out)[:n_valid])
        return peak

    def _make_sink(self, write):
        """Wrap a writer's write() with the NJAD host requantizer when
        requested (device emits float32 tiles in that mode)."""
        if self.dither is not DitherType.NJAD or self.bit_depth == 32:
            return write, lambda: None
        from dsd2dxd_tpu.native import lib as native

        if native is None:
            raise ConfigError(
                "NJAD dither needs the native extension (g++ build failed)")
        state = native.njad_new(self.source.info.channels)

        def sink(tile: np.ndarray) -> None:
            write(native.njad_quantize(state, tile, self.bit_depth))

        return sink, lambda: native.njad_free(state)

    def do_conversion(self, cancel: Optional[CancelFn] = None,
                      progress: Optional[ProgressFn] = None) -> None:
        """Run the conversion (reference src/main.rs:345, 429)."""
        from dsd2dxd_tpu.containers.pack import pack

        id3 = self.source.info.id3
        if id3 is not None and self.append_rate:
            # -a also appends " [<rate>]" to the album tag
            # (reference src/main.rs:121-124).
            from dsd2dxd_tpu.formats.id3 import parse_id3

            tag = parse_id3(id3)
            if tag is not None:
                tag.append_to_album(f" [{self.output_rate}]")
                id3 = tag.to_bytes()
        pack_dev_ok = (self.bit_depth in (16, 20, 24)
                       and self.dither is not DitherType.NJAD)
        pack_mode = 16 if self.bit_depth == 16 else 24
        shift = 4 if self.bit_depth == 20 else 0
        if self._out_path is None:
            out = sys.stdout.buffer

            def write(tile: np.ndarray) -> None:
                out.write(pack(tile, self.bit_depth, big_endian=False))

            if pack_dev_ok:
                self._packed = (pack_mode, shift, False, out.write)
            sink, cleanup = self._make_sink(write)
            try:
                self._run(cancel, progress, sink)
            finally:
                cleanup()
            out.flush()
            return
        self._out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self._out_path, "wb") as f:
            writer = self._make_writer(f, id3)
            if pack_dev_ok and hasattr(writer, "write_packed"):
                big_endian = self.output in (OutputType.AIFF, OutputType.AIFC)
                self._packed = (pack_mode, shift, big_endian,
                                writer.write_packed)
            try:
                sink, cleanup = self._make_sink(writer.write)
                try:
                    self._run(cancel, progress, sink)
                finally:
                    cleanup()
                    # finalize even on cancel/error: the header gets real
                    # sizes so a partial file is well-formed, not corrupt
                    writer.finalize()
            finally:
                # belt-and-braces: if finalize itself threw mid-write,
                # still release the native encoder (FLAC worker pool)
                close = getattr(writer, "close", None)
                if close is not None:
                    close()

    def check_level(self, cancel: Optional[CancelFn] = None,
                    progress: Optional[ProgressFn] = None) -> float:
        """Peak level in dBFS (reference dsd_levels/main.rs:252, 284)."""
        peak = self._run(cancel, progress, None)
        if peak <= 0.0:
            return float("-inf")
        return 20.0 * math.log10(peak)


def open_container(path: Path) -> DsdSource:
    """Open a .dsf/.dff container as a normalized DsdSource."""
    from dsd2dxd_tpu.formats.dff import open_dff
    from dsd2dxd_tpu.formats.dsf import open_dsf

    fmt = DsdFileFormat.from_path(path)
    if fmt is DsdFileFormat.DSF:
        src, _meta = open_dsf(path)
        return src
    if fmt is DsdFileFormat.DFF:
        src, _meta = open_dff(path)
        return src
    raise ConfigError(f"Not a DSD container: {path}")
