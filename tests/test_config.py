"""Config dataclass + XML-compat reader (reference: settings.cpp:53-144)."""

import pytest

from tpuflow.config import DataConstancy, FlowConfig, load_settings_xml

SETTINGS_XML = """<?xml version="1.0"?>
<OpticalFlow>
  <Input>
    <Path inputPath="/data/in/"/>
    <Mode Nx="128" Ny="96" imageType="8-bit">
      <Files file1="a.raw" file2="b.raw"/>
    </Mode>
  </Input>
  <Parameters>
    <Method mode="2d" run="flow" key="1"/>
    <Solver>
      <Iterations inner="5" outer="20"/>
      <Warping levels="20" scaling="0.9" medianRadius="5"/>
      <Model sigma="0.45" alpha="3.5" e_smooth="0.001" e_data="0.002"/>
    </Solver>
  </Parameters>
  <Output>
    <Path outputPath="/data/out/"/>
  </Output>
</OpticalFlow>
"""


def test_defaults_match_reference_cli():
    # reference: src/main.cpp:65-84
    cfg = FlowConfig()
    assert cfg.warp_levels_count == 50
    assert cfg.warp_scale_factor == 0.9
    assert cfg.outer_iterations_count == 40
    assert cfg.inner_iterations_count == 5
    assert cfg.equation_alpha == 35.0
    assert cfg.equation_smoothness == 0.001
    assert cfg.equation_data == 0.001
    assert cfg.median_radius == 5
    assert cfg.gaussian_sigma == 1.5
    assert cfg.data_constancy == DataConstancy.GREY


def test_validation():
    with pytest.raises(ValueError):
        FlowConfig(warp_scale_factor=1.0)
    with pytest.raises(ValueError):
        FlowConfig(median_radius=9)
    with pytest.raises(ValueError):
        FlowConfig(warp_levels_count=0)


def test_load_settings_xml(tmp_path):
    p = tmp_path / "settings.xml"
    p.write_text(SETTINGS_XML)
    flow, io = load_settings_xml(str(p))
    assert flow.warp_levels_count == 20
    assert flow.warp_scale_factor == pytest.approx(0.9)
    assert flow.outer_iterations_count == 20
    assert flow.inner_iterations_count == 5
    assert flow.equation_alpha == pytest.approx(3.5)
    assert flow.equation_smoothness == pytest.approx(0.001)
    assert flow.equation_data == pytest.approx(0.002)
    assert flow.median_radius == 5
    assert flow.gaussian_sigma == pytest.approx(0.45)
    assert io.width == 128 and io.height == 96
    assert io.input_path == "/data/in/" and io.output_path == "/data/out/"
    assert io.file_name1 == "a.raw" and io.file_name2 == "b.raw"
    assert io.press_key is True


# The reference repository's settings.xml layout (reference: settings.xml:3-27):
# comments, the full attribute set of each element (including the ones the
# parser ignores) and attributes in the reference's order.
REFERENCE_SETTINGS_XML = """<?xml version="1.0" encoding="UTF-8"?>
<!-- Optical flow settings -->
<OpticalFlow>
    <Input>
        <Path inputPath="./data/"/>
        <Mode imageType="8-bit" Nx="128" Ny="128">
            <!-- frame pair -->
            <Files file1="rub1.raw" file2="rub2.raw"/>
        </Mode>
    </Input>
    <Parameters>
        <Method run="flow" mode="2d" key="0"/>
        <Solver>
            <Iterations outer="40" inner="5"/>
            <Warping levels="20" scaling="0.9" medianRadius="5"/>
            <Model alpha="35" e_smooth="0.001" e_data="0.001" sigma="1.5"/>
        </Solver>
    </Parameters>
    <Output>
        <Path outputPath="./data/output/"/>
    </Output>
</OpticalFlow>
"""


def test_reference_settings_xml_parses(tmp_path):
    # A file laid out like the reference repo's own settings.xml must load
    # unchanged.
    p = tmp_path / "settings.xml"
    p.write_text(REFERENCE_SETTINGS_XML)
    flow, io = load_settings_xml(str(p))
    assert flow.warp_levels_count == 20
    assert flow.outer_iterations_count == 40
    assert flow.equation_alpha == pytest.approx(35.0)
    assert flow.gaussian_sigma == pytest.approx(1.5)
    assert io.width == 128 and io.height == 128
    assert io.press_key is False
