"""Command-line interface, argument-compatible with the reference binary.

Usage modes (reference: src/main.cpp:99-125):
  1. ``python -m tpuflow.cli``                      -> ./settings.xml
  2. ``python -m tpuflow.cli <settings.xml>``       -> given settings file
  3. ``python -m tpuflow.cli <f1> <f2> <w> <h> [counter] <outdir> [alpha sigma]``

Outputs per pair (reference: src/main.cpp:205-213):
  ``<out>/<counter>flow-u-<w>-<h>.raw``  float32 RAW u
  ``<out>/<counter>flow-v-<w>-<h>.raw``  float32 RAW v
  ``<out>/<counter>res.pgm``             P6 PPM color-circle visualization
  ``<out>/<counter>amp-<w>-<h>.raw``     float32 RAW magnitude

Deviations from the reference (all bug fixes, SURVEY.md §3.5):
  * the positional mode's out-of-bounds argv read at argc==6 is fixed —
    the output dir is always the argument after width/height/counter;
  * input frames are read as u8 or f32 by file size (the reference always
    used the f32 reader, which cannot load its own bundled u8 data);
  * no "press enter to continue" blocking prompt.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from tpuflow.config import DataConstancy, FlowConfig, IOConfig, load_settings_xml


def _positional_mode(argv) -> tuple[FlowConfig, IOConfig]:
    """<f1> <f2> <w> <h> [counter] <outdir> [alpha sigma]"""
    if len(argv) not in (5, 6, 8):
        raise SystemExit(
            "usage: tpuflow <file1> <file2> <width> <height> [counter] "
            "<outdir> [alpha sigma]  |  tpuflow [settings.xml]"
        )
    file1, file2 = argv[0], argv[1]
    width, height = int(argv[2]), int(argv[3])
    counter = ""
    rest = argv[4:]
    if len(rest) in (2, 4):  # counter present
        counter, outdir = rest[0], rest[1]
        sweep = rest[2:]
    else:
        outdir = rest[0]
        sweep = rest[1:]

    cfg = FlowConfig()
    if sweep:
        alpha, sigma = float(sweep[0]), float(sweep[1])
        cfg = dataclasses.replace(cfg, equation_alpha=alpha, gaussian_sigma=sigma)
        # Parameter-sweep runs embed alpha/sigma in the output names
        # (reference: src/main.cpp:119-124).
        counter = f"alpha{sweep[0]}_sigma{sweep[1]}_"

    io = IOConfig(
        width=width,
        height=height,
        input_path="",
        output_path=outdir,
        file_name1=file1,
        file_name2=file2,
        counter=counter,
    )
    return cfg, io


def _sequence_mode(flags) -> int:
    """Streaming mode: consecutive pairs over a sorted frame glob."""
    import glob as globmod

    from tpuflow.parallel.multihost import initialize_distributed, process_sequence

    if not flags.size or not flags.out:
        raise SystemExit("--sequence requires --size WxH and --out DIR")
    w, h = (int(x) for x in flags.size.lower().split("x"))
    frames = sorted(globmod.glob(flags.sequence))
    if len(frames) < 2:
        raise SystemExit(f"--sequence matched {len(frames)} files; need >= 2")
    pairs = list(zip(frames[:-1], frames[1:]))

    initialize_distributed()
    cfg = FlowConfig()
    if flags.constancy:
        cfg = dataclasses.replace(cfg, data_constancy=DataConstancy(flags.constancy))
    completed = process_sequence(pairs, w, h, flags.out, cfg,
                                 chain=flags.chain)
    if not flags.quiet:
        print(f"processed {len(completed)} pairs -> {flags.out}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--constancy", choices=[c.value for c in DataConstancy])
    parser.add_argument("--sequence", metavar="GLOB",
                        help="process consecutive pairs of all frames matching "
                             "a glob (streaming, resumable via manifest)")
    parser.add_argument("--size", metavar="WxH",
                        help="frame size for --sequence mode, e.g. 584x388")
    parser.add_argument("--out", metavar="DIR", help="output dir for --sequence")
    parser.add_argument("--chain", type=int, default=1, metavar="N",
                        help="solve N pairs per dispatch in --sequence mode "
                             "(ONE compiled program + ONE stacked download "
                             "per N pairs; amortizes per-call dispatch and "
                             "host synchronization)")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--help", action="help")
    flags, positional = parser.parse_known_args(argv)

    if flags.sequence:
        return _sequence_mode(flags)

    if len(positional) >= 4:
        cfg, io = _positional_mode(positional)
    elif len(positional) >= 2:
        # 2-3 bare args: an incomplete positional invocation, not a
        # settings file — say so instead of "settings file not found: <f1>".
        raise SystemExit(
            "usage: tpuflow <file1> <file2> <width> <height> [counter] "
            "<outdir> [alpha sigma]  |  tpuflow [settings.xml]"
        )
    else:
        settings = positional[0] if positional else "settings.xml"
        if not os.path.exists(settings):
            raise SystemExit(f"settings file not found: {settings}")
        cfg, io = load_settings_xml(settings)

    if flags.constancy:
        cfg = dataclasses.replace(cfg, data_constancy=DataConstancy(flags.constancy))

    from tpuflow.io.raw import read_frame
    from tpuflow.io import write_flow_image_rgb, write_magnitude_f32, write_raw_f32
    from tpuflow.solver.flow2d import compute_flow

    os.makedirs(io.output_path or ".", exist_ok=True)

    p1 = os.path.join(io.input_path, io.file_name1)
    p2 = os.path.join(io.input_path, io.file_name2)
    frame_0 = read_frame(p1, io.width, io.height)
    frame_1 = read_frame(p2, io.width, io.height)

    if not flags.quiet:
        print(f"tpuflow: {io.width}x{io.height}, {cfg.data_constancy.value} "
              f"constancy, levels<={cfg.warp_levels_count}, "
              f"{cfg.outer_iterations_count}x{cfg.inner_iterations_count} iterations")

    t0 = time.perf_counter()
    result = compute_flow(frame_0, frame_1, cfg)
    if not flags.quiet:
        print(f"computed in {time.perf_counter() - t0:.3f}s "
              f"({result.megapixels_per_second:.2f} Mpix/s steady-state)")

    suffix = f"-{io.width}-{io.height}.raw"
    out = io.output_path
    c = io.counter
    write_raw_f32(os.path.join(out, f"{c}flow-u{suffix}"), result.u)
    write_raw_f32(os.path.join(out, f"{c}flow-v{suffix}"), result.v)
    write_flow_image_rgb(result.u, result.v, 10, os.path.join(out, f"{c}res.pgm"))
    write_magnitude_f32(result.u, result.v, os.path.join(out, f"{c}amp{suffix}"))

    if not flags.quiet:
        print(f"wrote {c}flow-u{suffix}, {c}flow-v{suffix}, {c}res.pgm, "
              f"{c}amp{suffix} to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
