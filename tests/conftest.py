"""Test configuration: an 8-device virtual CPU mesh set up before JAX
loads, so sharding tests run without accelerators. Tests marked ``gpu``
need the card; they skip here and run on it through chip_smoke.py,
which selects the GPU before this file is loaded."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent XLA compile cache for the suite (utils/device.py): repeat
# runs reuse the compiled steps. DSD2DXD_COMPILE_CACHE=off disables.
from dsd2dxd_tpu.utils.device import enable_compile_cache

enable_compile_cache()

# Small engine tiles for the short test fixtures (the production default
# of 4 MiB/ch x rate multiplier just burns CPU time on padding here).
import dsd2dxd_tpu.pipeline.engine as _engine

_engine._DEFAULT_TILE_TARGET = 512 * 1024

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REFERENCE = Path("/root/reference")
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="session")
def reference_fixtures() -> Path:
    if not REFERENCE.is_dir():
        pytest.skip("reference tree not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def data_dir() -> Path:
    DATA.mkdir(exist_ok=True)
    return DATA


# bump when synth_tone_dsd / write_dsf behavior changes: the cache files
# are gitignored and persist across runs, so existence alone would keep
# validating against stale pre-change fixtures (same scheme as
# filters/design._DESIGN_VERSION)
_SYNTH_VERSION = 1


def _synth_cached(name: str, synth_fn) -> Path:
    """Generate a fixture once and cache it under tests/data, keyed on
    _SYNTH_VERSION."""
    DATA.mkdir(exist_ok=True)
    path = DATA / f"v{_SYNTH_VERSION}_{name}"
    if not path.exists():
        synth_fn(path)
    return path


@pytest.fixture(scope="session")
def tone_dsd64_stereo_dsf() -> Path:
    """Synthesized stand-in for the stripped test/1kHz_stereo_p.dsf
    (SURVEY.md §4.2 missing-fixture list): 1 kHz stereo DSD64, 0.5 s."""
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    def make(path):
        planes = synth_tone_dsd(1000.0, 0.5, 2_822_400, amplitude=0.5, channels=2)
        write_dsf(path, planes, 2_822_400, lsb_first=True)

    return _synth_cached("1kHz_stereo_p_synth.dsf", make)
