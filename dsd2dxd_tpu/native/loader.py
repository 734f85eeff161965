"""Build-on-demand loader for the native C++ library (ctypes).

Compiles native/src/*.cc into _dsdkit.so with g++ the first time it is
needed (or when sources are newer than the cached .so), then exposes a
typed wrapper. No pybind11 dependency — plain C ABI + ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "_build"
_SO_PATH = _BUILD_DIR / "_dsdkit.so"


def _needs_build() -> bool:
    if not _SO_PATH.exists():
        return True
    so_mtime = _SO_PATH.stat().st_mtime
    return any(p.stat().st_mtime > so_mtime for p in _SRC_DIR.glob("*.cc"))


def build() -> Path:
    sources = sorted(_SRC_DIR.glob("*.cc"))
    if not sources:
        raise FileNotFoundError("no native sources in native/src")
    _BUILD_DIR.mkdir(exist_ok=True)
    # compile to a pid-suffixed tmp and rename: a concurrent process
    # must never dlopen a half-written .so (same race + fix as the
    # filter cache, filters/design.py)
    tmp = _SO_PATH.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fvisibility=hidden", "-o", str(tmp),
    ] + [str(s) for s in sources]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        tmp.replace(_SO_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    return _SO_PATH


class NativeLib:
    """Typed wrapper over the C ABI. Functions are attached lazily as the
    native surface grows (see native/src/dsdkit.cc for the ABI)."""

    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        self._setup()

    def _setup(self) -> None:
        d = self._dll
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        d.dsdkit_dsm2_bits.argtypes = [f64p, u8p, ctypes.c_size_t]
        d.dsdkit_dsm2_bits.restype = None

        d.dsdkit_flac_new.argtypes = [ctypes.c_uint32] * 4
        d.dsdkit_flac_new.restype = ctypes.c_void_p
        d.dsdkit_flac_feed.argtypes = [ctypes.c_void_p, i32p, ctypes.c_size_t]
        d.dsdkit_flac_feed.restype = None
        d.dsdkit_flac_finish.argtypes = [ctypes.c_void_p]
        d.dsdkit_flac_finish.restype = None
        d.dsdkit_flac_pending.argtypes = [ctypes.c_void_p]
        d.dsdkit_flac_pending.restype = ctypes.c_size_t
        d.dsdkit_flac_drain.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
        d.dsdkit_flac_drain.restype = ctypes.c_size_t
        d.dsdkit_flac_header.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int]
        d.dsdkit_flac_header.restype = None
        d.dsdkit_flac_free.argtypes = [ctypes.c_void_p]
        d.dsdkit_flac_free.restype = None

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        d.dsdkit_njad_new.argtypes = [ctypes.c_uint32]
        d.dsdkit_njad_new.restype = ctypes.c_void_p
        d.dsdkit_njad_quantize.argtypes = [
            ctypes.c_void_p, f32p, i32p, ctypes.c_size_t,
            ctypes.c_uint32, ctypes.c_int]
        d.dsdkit_njad_quantize.restype = ctypes.c_int
        d.dsdkit_njad_free.argtypes = [ctypes.c_void_p]
        d.dsdkit_njad_free.restype = None

    def dsm2_bits(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float64)
        out = np.empty(x.shape[0], dtype=np.uint8)
        self._dll.dsdkit_dsm2_bits(x, out, x.shape[0])
        return out

    # -- FLAC encoder handle -------------------------------------------------

    def flac_new(self, rate: int, channels: int, bps: int,
                 block_size: int = 4096) -> int:
        enc = self._dll.dsdkit_flac_new(rate, channels, bps, block_size)
        if not enc:
            from dsd2dxd_tpu.utils.errors import ConfigError

            raise ConfigError(
                f"FLAC encoder rejects rate={rate} channels={channels} "
                f"bps={bps} block_size={block_size} (bps 4-24, <=8 "
                f"channels, block 16-32768)")
        return enc

    def flac_feed(self, enc: int, samples: np.ndarray) -> None:
        """samples: (frames, channels) int32, interleaved in memory."""
        samples = np.ascontiguousarray(samples, dtype=np.int32)
        self._dll.dsdkit_flac_feed(enc, samples.reshape(-1),
                                   samples.shape[0])

    def flac_finish(self, enc: int) -> None:
        self._dll.dsdkit_flac_finish(enc)

    def flac_drain(self, enc: int) -> bytes:
        n = self._dll.dsdkit_flac_pending(enc)
        if n == 0:
            return b""
        out = np.empty(n, dtype=np.uint8)
        got = self._dll.dsdkit_flac_drain(enc, out, n)
        return out[:got].tobytes()

    def flac_header(self, enc: int, is_last: bool) -> bytes:
        out = np.empty(42, dtype=np.uint8)
        self._dll.dsdkit_flac_header(enc, out, 1 if is_last else 0)
        return out.tobytes()

    def flac_free(self, enc: int) -> None:
        self._dll.dsdkit_flac_free(enc)

    # -- NJAD requantizer ----------------------------------------------------

    def njad_new(self, channels: int) -> int:
        state = self._dll.dsdkit_njad_new(channels)
        if not state:
            from dsd2dxd_tpu.utils.errors import ConfigError

            raise ConfigError(
                f"NJAD dither supports 1-16 channels, got {channels}")
        return state

    def njad_quantize(self, state: int, samples: np.ndarray,
                      bits: int) -> np.ndarray:
        """samples: (frames, channels) float32 full-scale ±1 -> int32."""
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        frames, channels = samples.shape
        out = np.empty((frames, channels), dtype=np.int32)
        rc = self._dll.dsdkit_njad_quantize(state, samples, out, frames,
                                             channels, bits)
        if rc != 0:
            from dsd2dxd_tpu.utils.errors import ConfigError

            raise ConfigError(
                f"NJAD quantize: {channels} channels / {bits} bits does "
                "not match the handle (per-channel Benford state must "
                "not alias)")
        return out

    def njad_free(self, state: int) -> None:
        self._dll.dsdkit_njad_free(state)


def load() -> NativeLib | None:
    try:
        if _needs_build():
            build()
        return NativeLib(ctypes.CDLL(str(_SO_PATH)))
    except (subprocess.CalledProcessError, OSError, FileNotFoundError):
        return None
