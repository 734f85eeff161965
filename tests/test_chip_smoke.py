"""chip_smoke.py's phases at tiny sizes on the CPU backend: the same
functions main() calls at album-length sizes on the card. Also pins that
chip_smoke.py and bench.py refuse to report anything without a GPU."""

import dataclasses
import runpy
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import chip_smoke as cs
from conftest import REPO

TINY = {c.name: dataclasses.replace(c, seconds=0.05) for c in cs.CELLS}


def test_fixture_build_round_trips(tmp_path):
    """Each container the cells use parses back to the bits written,
    and the DFF carries its ID3 tag."""
    from dsd2dxd_tpu.formats.dsd_types import DsdRate, Endianness, FmtType
    from dsd2dxd_tpu.formats.id3 import parse_id3
    from dsd2dxd_tpu.formats.source import open_raw_file
    from dsd2dxd_tpu.pipeline.engine import open_container

    for name in ("A", "B", "C"):
        cell = TINY[name]
        planes = cs.tone_planes(cell.rate_hz, cell.seconds)
        assert planes.shape == (2, round(cell.seconds * cell.rate_hz) // 8)
        path = cs.build_fixture(cell, tmp_path)
        if cell.container == "raw":
            src = open_raw_file(path, 2, DsdRate.DSD64, FmtType.INTERLEAVED,
                                Endianness.MSB_FIRST, 4096)
        else:
            src = open_container(path)
        parts = []
        while (b := src.read(1 << 16)) is not None:
            parts.append(b)
        got = np.concatenate(parts, axis=1)
        np.testing.assert_array_equal(got[:, :planes.shape[1]], planes)
        if cell.id3:
            assert parse_id3(src.info.id3).get_text("TIT2") == cs.ID3_TITLE


@pytest.mark.parametrize("name", ["A", "B", "C", "D", "E"])
def test_cell_conversion_and_output_checks(name, tmp_path):
    """One conversion per output type (WAV, stdout, FLAC with NJAD and
    ID3, FLAC, AIFC) through the cell's entry point, the output checks,
    and the device-step timing."""
    cell = TINY[name]
    src = cs.build_fixture(cell, tmp_path)
    wall, out = cs.convert(cell, src, tmp_path / "out")
    assert wall > 0 and out.exists()
    res = cs.check_output(cell, out)
    assert res["frames"] == round(cell.seconds * cell.out_hz)
    assert abs(res["peak_hz"] - 1000.0) < 50
    if cell.id3:
        assert res["vorbis_title"] == cs.ID3_TITLE
    dev = cs.device_step(cs.make_converter(cell, src, tmp_path), reps=1)
    assert dev["tiles"] == 1 and dev["step_s"] > 0


def test_output_check_rejects_wrong_length(tmp_path):
    cell = TINY["A"]
    src = cs.build_fixture(cell, tmp_path)
    _, out = cs.convert(cell, src, tmp_path / "out")
    with pytest.raises(AssertionError, match="frames"):
        cs.check_output(dataclasses.replace(cell, seconds=0.06), out)


@pytest.mark.parametrize("name", ["A", "D", "E"])
def test_oracle_comparison_spans_a_tile_boundary(name, tmp_path):
    res = cs.oracle_check(TINY[name], tmp_path, window_s=0.005,
                          tile_target_bytes=4096)
    w0, w1 = res["window"]
    assert w0 < res["tile_frames"] < w1
    assert res["rms_lsb"] < cs.RMS_BOUND_LSB
    assert res["int_max_diff"] <= cs.INT_BOUND_LSB


def test_level_check_cell(tmp_path):
    cell = TINY["A"]
    src = cs.build_fixture(cell, tmp_path)
    res = cs.run_level_cell(cell, src)
    assert -7.0 < res["peak_dbfs"] < -5.0
    assert res["tiles"] == 1


def test_four_card_phase_on_virtual_devices(tmp_path, monkeypatch):
    """The --four-cards phase on 4 of the 8 virtual CPU devices: the
    batch spreads over them byte-identically, the long file shards."""
    from dsd2dxd_tpu.utils import device

    devs = jax.devices()[:4]
    monkeypatch.setattr(device, "batch_devices", lambda: list(devs))
    real_mesh = device.stream_mesh
    monkeypatch.setattr(device, "stream_mesh", lambda: (
        Mesh(np.array(devs), ("tile",)) if real_mesh() is not None
        else None))
    res = cs.four_cards(tmp_path, devices=devs, n_files=4,
                        batch_seconds=0.05, long_seconds=0.1)
    assert res["batch_identical"] == 4
    assert res["long_max_diff"] < 1e-4
    assert len(res["peaks"]) == 4


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) == 2
    out = capsys.readouterr().out
    assert out == "" and '"ok": true' not in out


def test_bench_refuses_without_gpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit) as e:
        runpy.run_path(str(REPO / "bench.py"), run_name="__main__")
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert out == "" and "null" not in out
