"""CLI end-to-end: positional and settings-file modes, reference-format
outputs (reference: src/main.cpp:99-125,205-213)."""

import os

import numpy as np
import pytest

from tpuflow.cli import main
from tpuflow.io import write_raw_u8, write_raw_f32


SETTINGS_TMPL = """<?xml version="1.0"?>
<OpticalFlow>
  <Input>
    <Path inputPath="{inp}/"/>
    <Mode Nx="32" Ny="24" imageType="8-bit">
      <Files file1="a.raw" file2="b.raw"/>
    </Mode>
  </Input>
  <Parameters>
    <Method mode="2d" run="flow" key="0"/>
    <Solver>
      <Iterations inner="2" outer="3"/>
      <Warping levels="2" scaling="0.7" medianRadius="3"/>
      <Model sigma="0.8" alpha="35" e_smooth="0.001" e_data="0.001"/>
    </Solver>
  </Parameters>
  <Output>
    <Path outputPath="{out}/"/>
  </Output>
</OpticalFlow>
"""


def make_frames(d, w=32, h=24):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f0 = 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2) ** 2) / 32.0)
    f1 = 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2 - 1) ** 2) / 32.0)
    write_raw_u8(os.path.join(d, "a.raw"), f0)
    write_raw_u8(os.path.join(d, "b.raw"), f1)


def test_settings_mode(tmp_path):
    inp = tmp_path / "in"
    out = tmp_path / "out"
    inp.mkdir()
    make_frames(str(inp))
    settings = tmp_path / "settings.xml"
    settings.write_text(SETTINGS_TMPL.format(inp=inp, out=out))

    assert main([str(settings), "--quiet"]) == 0
    names = sorted(os.listdir(out))
    assert names == ["amp-32-24.raw", "flow-u-32-24.raw", "flow-v-32-24.raw", "res.pgm"]
    u = np.fromfile(out / "flow-u-32-24.raw", dtype="<f4")
    assert u.size == 32 * 24 and np.isfinite(u).all()
    assert (out / "res.pgm").read_bytes().startswith(b"P6 \n32 24 \n255\n")


def test_positional_mode_with_counter(tmp_path):
    make_frames(str(tmp_path))
    out = tmp_path / "out"
    rc = main(
        [
            str(tmp_path / "a.raw"), str(tmp_path / "b.raw"),
            "32", "24", "007", str(out), "--quiet",
        ]
    )
    assert rc == 0
    assert sorted(os.listdir(out))[0].startswith("007amp")


def test_positional_sweep_mode_embeds_params(tmp_path):
    make_frames(str(tmp_path))
    out = tmp_path / "out"
    rc = main(
        [
            str(tmp_path / "a.raw"), str(tmp_path / "b.raw"),
            "32", "24", "x", str(out), "10", "0.8", "--quiet",
        ]
    )
    assert rc == 0
    assert any(n.startswith("alpha10_sigma0.8_flow-u") for n in os.listdir(out))


def test_f32_frames_autodetected(tmp_path):
    ys, xs = np.mgrid[0:24, 0:32].astype(np.float32)
    f = 100.0 * np.exp(-((ys - 12) ** 2 + (xs - 16) ** 2) / 32.0)
    write_raw_f32(os.path.join(tmp_path, "a.raw"), f)
    write_raw_f32(os.path.join(tmp_path, "b.raw"), f)
    out = tmp_path / "out"
    rc = main(
        [str(tmp_path / "a.raw"), str(tmp_path / "b.raw"), "32", "24", str(out), "--quiet"]
    )
    assert rc == 0
    u = np.fromfile(out / "flow-u-32-24.raw", dtype="<f4")
    assert np.abs(u).max() < 1e-3  # identical frames -> zero flow


def test_sequence_mode(tmp_path):
    # Three frames -> two consecutive pairs, resumable.
    ys, xs = np.mgrid[0:16, 0:24].astype(np.float32)
    for i in range(3):
        img = 200.0 * np.exp(-((ys - 8) ** 2 + (xs - 12 - 0.5 * i) ** 2) / 18.0)
        write_raw_u8(os.path.join(tmp_path, f"seq_{i:03d}.raw"), img)
    out = tmp_path / "seqout"
    rc = main([
        "--sequence", str(tmp_path / "seq_*.raw"),
        "--size", "24x16", "--out", str(out), "--quiet",
    ])
    assert rc == 0
    files = os.listdir(out)
    assert "00000_flow-u-24-16.raw" in files and "00001_res.pgm" in files
    assert "manifest.jsonl" in files


def test_sequence_mode_requires_size_and_out(tmp_path):
    with pytest.raises(SystemExit):
        main(["--sequence", str(tmp_path / "x_*.raw")])


def test_bad_usage():
    with pytest.raises(SystemExit):
        main(["one", "two", "3"])
    with pytest.raises(SystemExit):
        main(["missing-settings.xml"])


def test_model_presets():
    from tpuflow.models import brox, full_model, horn_schunck, reference_default, xray_log
    from tpuflow.config import DataConstancy

    assert horn_schunck().warp_levels_count == 1
    assert horn_schunck().gaussian_sigma == 0.0
    assert brox().data_constancy == DataConstancy.GRADIENT
    assert full_model().median_radius == 5
    assert xray_log().data_constancy == DataConstancy.LOG_DERIVATIVES
    assert reference_default() == __import__("tpuflow").FlowConfig()
