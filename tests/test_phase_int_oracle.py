"""24-bit undithered output of the phase step against the quantized f64
oracle, every (bank, input rate, output rate) cell.

Bound: the float check (tests/test_phase.py) holds the f32 chain within
4 LSB24 of the oracle, and rounding both sides to integers cannot widen
a difference beyond its ceiling, so |diff| <= 4. (Within 1 LSB would
need every float error under 1 LSB24; the f32 chain reaches 1.6-3.0
LSB24 at the tails of its error distribution.) The integer path is also
held to the device's own float output: quantizing that float must give
the same integers up to one rounding step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsd2dxd_tpu.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu.formats.dsd_types import DitherType, rate_cells
from dsd2dxd_tpu.ops.dsm import synth_tone_dsd
from dsd2dxd_tpu.ops.phase import (
    build_chain_plans,
    chain_tile_unit_bits,
    init_phase_hists,
    make_phase_step,
)
from dsd2dxd_tpu.ops.resample import StepConfig, chain_reference

CELLS = rate_cells()


def _quantize24(y: np.ndarray) -> np.ndarray:
    return np.clip(np.round(y * 2.0 ** 23), -2 ** 23, 2 ** 23 - 1
                   ).astype(np.int64)


@pytest.mark.parametrize(
    "filt,rate,out_hz", CELLS,
    ids=[f"{f.name}-{r.name}-{o}" for f, r, o in CELLS])
def test_int24_undithered_matches_quantized_oracle(filt, rate, out_hz):
    chain = get_chain(filt, rate, out_hz)
    plans = build_chain_plans(chain)
    unit = chain_tile_unit_bits(plans)
    bits = -(-int(3000 / chain_ratio(chain)) // unit) * unit
    planes = synth_tone_dsd(997.0, bits / rate.hz, rate.hz, amplitude=0.5,
                            channels=2, phase_per_ch=1.0)
    outs = {}
    for depth in (24, 32):
        cfg = StepConfig(channels=2, tile_bytes=planes.shape[1],
                         bit_depth=depth, dither=DitherType.NONE,
                         level_db=0.0)
        out, _peak, _ = make_phase_step(chain, cfg)(
            jnp.asarray(planes), init_phase_hists(plans, 2),
            jax.random.PRNGKey(0))
        outs[depth] = np.asarray(out)
    got = outs[24].astype(np.int64)
    ref = _quantize24(chain_reference(chain, planes).T[:len(got)])
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 4
    own = _quantize24(outs[32].astype(np.float64))
    assert np.abs(got - own).max() <= 1
