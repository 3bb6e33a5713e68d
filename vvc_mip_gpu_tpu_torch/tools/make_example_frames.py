"""Generate example input CSVs in the reference's frame format.

The port's counterpart of the repository's tools/make_example_frames.py:
the same arguments and the same bytes, written through the port's C
frame writer (io/frames.py ``write_frames_csv``, csrc/io_native.c).  The
reference ships `data/original_frames_0_1.csv` samples (reference
README.md "Usage/Examples"; one pixel row of comma-separated 10-bit luma
samples per line, frames concatenated vertically, main.cpp:318-387);
those are not redistributable, so this tool writes deterministic
pseudo-video (``synthetic_frames``) that `-o/--OriginalFrames` accepts:

    python -m vvc_mip_gpu_tpu_torch.tools.make_example_frames \
        data/original_frames_0_1.csv --resolution 1920x1080 --frames 2
    python -m vvc_mip_gpu_tpu_torch.cli -f 2 -s 1920x1080 \
        -o data/original_frames_0_1.csv -l MIP_decisions_log
"""

from __future__ import annotations

import argparse
import os

from vvc_mip_gpu_tpu_torch.io import frames as fio


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("output")
    p.add_argument("--resolution", default="1920x1080")
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    w, h = (int(v) for v in args.resolution.lower().split("x"))
    fr = fio.synthetic_frames(args.frames, w, h, seed=args.seed)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    fio.write_frames_csv(args.output, fr)
    print(f"wrote {args.output}: {args.frames} frames of {w}x{h} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
