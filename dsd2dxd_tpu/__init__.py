"""dsd2dxd_tpu — a GPU-accelerated DSD→PCM/DXD transcoding framework.

Built from scratch with the capabilities of the reference CLI tool
``clone206/dsd2dxd`` (Rust, CPU), with the DSP on an accelerator:

- the hot DSP path (1-bit unpack, polyphase FIR decimation, level scaling,
  dither, requantization, peak tracking) runs on the device as
  channel-batched, tiled JAX/XLA computations;
- container parsing (.dsf/.dff), ID3v2 metadata, and encoders
  (WAV/AIFF/AIFC/FLAC) run on the host, with the byte-hot paths
  (FLAC encoding, noise-shaped dither) in a native C++ extension
  (``dsd2dxd_tpu.native``);
- multi-device scale comes from spreading files over devices, or one
  stream's overlap-save tiles over a ``jax.sharding.Mesh``.

Public API mirrors the reference engine crate ``rdsd2pcm``
(see /root/reference/src/main.rs:27-31 for the reference surface).
"""

from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    DsdFileFormat,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
    ProgressUpdate,
    ONE_HUNDRED_PERCENT,
)
from dsd2dxd_tpu.formats.discover import find_dsd_files
from dsd2dxd_tpu.pipeline.engine import Converter

__version__ = "0.1.0"

__all__ = [
    "DitherType",
    "DsdFileFormat",
    "DsdRate",
    "Endianness",
    "FilterType",
    "FmtType",
    "OutputType",
    "ProgressUpdate",
    "ONE_HUNDRED_PERCENT",
    "find_dsd_files",
    "Converter",
]
