"""Tests that need an NVIDIA GPU. They skip elsewhere; chip_smoke.py
runs them on the card (python chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    FilterType,
    OutputType,
    rate_cells,
)
from dsd2dxd_tpu.ops.dsm import synth_tone_dsd
from dsd2dxd_tpu.ops.phase import (
    build_chain_plans,
    chain_tile_unit_bits,
    init_phase_hists,
    make_phase_step,
)
from dsd2dxd_tpu.ops.resample import StepConfig, chain_reference

pytestmark = pytest.mark.gpu
CELLS = rate_cells()


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; runs on the card through "
                    "chip_smoke.py")
    return jax.devices()[0]


@pytest.mark.parametrize(
    "filt,rate,out_hz", CELLS,
    ids=[f"{f.name}-{r.name}-{o}" for f, r, o in CELLS])
def test_phase_step_on_gpu_matches_f64_oracle(gpu, filt, rate, out_hz):
    """Every cell's compiled step on the card stays under the 24-bit
    TPDF floor against the f64 oracle (the CPU suite's bounds)."""
    chain = get_chain(filt, rate, out_hz)
    plans = build_chain_plans(chain)
    unit = chain_tile_unit_bits(plans)
    bits = -(-int(20000 / chain_ratio(chain)) // unit) * unit
    planes = synth_tone_dsd(1000.0, bits / rate.hz, rate.hz, amplitude=0.5,
                            channels=2, phase_per_ch=1.0)
    cfg = StepConfig(channels=2, tile_bytes=planes.shape[1], bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    out, _peak, _ = make_phase_step(chain, cfg)(
        jax.device_put(planes, gpu), init_phase_hists(plans, 2),
        jax.random.PRNGKey(0))
    err = (np.asarray(out).astype(np.float64)
           - chain_reference(chain, planes).T[:len(out)]) * 2.0 ** 23
    assert np.sqrt(np.mean(err ** 2)) < 0.41
    assert np.abs(err).max() < 4


def test_dithered_conversion_is_reproducible_on_gpu(gpu, tmp_path):
    """The same file converts to the same bytes twice on the card, TPDF
    dither included: the four-card batch check compares bytes."""
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.pipeline.engine import Converter

    src = tmp_path / "tone.dsf"
    write_dsf(src, synth_tone_dsd(1000.0, 0.2, 5_644_800, amplitude=0.5,
                                  channels=2), 5_644_800, lsb_first=True)
    outs = []
    for name in ("a", "b"):
        conv = Converter.from_container(
            bit_depth=24, output=OutputType.FLAC, level_db=0.0,
            output_rate=176400, out_dir=tmp_path / name,
            dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
            append_rate=False, base_dir=tmp_path, input_path=src)
        conv.do_conversion()
        outs.append(conv.output_path().read_bytes())
    assert outs[0] == outs[1]
    assert jnp.zeros(1).devices() == {gpu}
