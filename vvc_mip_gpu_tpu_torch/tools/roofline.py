"""Analytic roofline of the port's MIP cost search on an NVIDIA H100.

The counterpart of the JAX package's tools/roofline.py, with the H100's
rates, and the port's one op model: chip_smoke.py takes its per-class
bounds from here.  Per shape class and batch it counts the integer
operations the cost kernels must execute and the bytes they must move,
and converts both to time.

Op model per class (h x w CU, 2M modes, r = reduced prediction size; the
JAX tool's count, from ops/pallas/distortion.py and the reference's
intra.cl:545-1171): per sample and mode 1 (diff) + 2 (SAD: abs,
accumulate) + 4 (SATD butterflies) + 2 (SATD abs, accumulate); ~4 per
upsampled sample (r*w horizontal when r < w, h*w vertical when r < h or
r < w); 4*r*r for the prediction epilogue; 6 per (CU, mode).

Bytes per class launch: the batch's int16 frames read once, the class's
CU table (int32 [nCU, 3]) and its SizeId's weights (int32 [M, S, C]) read
once, one int32 cost per (frame, CU, mode) written once.

Rates: int32 results 128 per clock per SM (the FMA and integer pipes, 64
each: CUDA C++ Programming Guide, arithmetic instruction throughput, cc
9.0) x SMs x the maximum SM clock, read from the card
(torch.cuda.get_device_properties, nvidia-smi --query-gpu=clocks.max.sm)
or given as flags; memory 3.35 TB/s (H100 SXM data sheet).

    python -m vvc_mip_gpu_tpu_torch.tools.roofline [-s 1920x1080]
        [--batch 16] [--sms 132 --clock-mhz 1980] [--json]

Without --sms and --clock-mhz it needs a CUDA card and nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from vvc_mip_gpu_tpu_torch.mip_weights import padded_matrix
from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans

INT32_OPS_PER_CLK_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_OF_SIZE_ID = ("mip_cost_sid0", "mip_cost_sid1", "mip_cost_sid2")


def class_ops(h: int, w: int, r: int, two_m: int, n_cu: int) -> int:
    """Integer operations one class needs for one frame."""
    per_sample = 1 + 2 + 4 + 2  # diff, SAD, butterflies, SATD abs+acc
    up_ops = 0
    if r < w:
        up_ops += 4 * r * w  # horizontal pass produces r*w
    if r < h or r < w:
        up_ops += 4 * h * w  # vertical (or only) pass produces h*w
    ops_mode = per_sample * h * w + up_ops + 4 * r * r + 6
    return n_cu * two_m * ops_mode


def class_work(width: int, height: int, batch: int) -> list[dict]:
    """Per shape class, in ``class_plans`` order: {"class": "WxH",
    "kernel", "n_cu", "ops", "bytes"} of one launch over ``batch``
    frames."""
    rows = []
    for cplan in class_plans(width, height):
        s = cplan.shape
        n_cu = sum(g.n_rows * g.n_cols for g in cplan.groups)
        nbytes = (batch * width * height * 2 + n_cu * 3 * 4
                  + padded_matrix(s.size_id).size * 4
                  + batch * n_cu * s.total_modes * 4)
        rows.append({
            "class": f"{s.width}x{s.height}",
            "kernel": KERNEL_OF_SIZE_ID[s.size_id], "n_cu": n_cu,
            "ops": batch * class_ops(s.height, s.width, s.reduced_pred_size,
                                     s.total_modes, n_cu),
            "bytes": nbytes})
    return rows


def int32_rate(sms: int, clock_mhz: float) -> float:
    """Peak int32 results per second."""
    return INT32_OPS_PER_CLK_PER_SM * sms * clock_mhz * 1e6


def card_rate() -> tuple[int, float]:
    """(SM count, maximum SM clock in MHz) of CUDA card 0."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --sms and --clock-mhz")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return sms, float(clock)


def bound(ops: int, nbytes: int, rate: float) -> tuple[float, str]:
    """(least milliseconds, "operations" or "bytes", whichever bounds)."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def report(width: int, height: int, batch: int, sms: int,
           clock_mhz: float) -> dict:
    rate = int32_rate(sms, clock_mhz)
    classes = class_work(width, height, batch)
    for row in classes:
        row["bound_ms"], row["bound_by"] = bound(row["ops"], row["bytes"],
                                                 rate)
    total_ms, by = bound(sum(r["ops"] for r in classes),
                         sum(r["bytes"] for r in classes), rate)
    return {"width": width, "height": height, "batch": batch, "sms": sms,
            "clock_mhz": clock_mhz, "int32_tops": rate / 1e12,
            "hbm_tb_s": HBM_BYTES_PER_S / 1e12, "classes": classes,
            "bound_ms": total_ms, "bound_by": by}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-s", "--resolution", default="1920x1080")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--sms", type=int, default=None)
    p.add_argument("--clock-mhz", type=float, default=None)
    p.add_argument("--json", action="store_true",
                   help="print one JSON object instead of the table")
    args = p.parse_args(argv)
    width, height = (int(v) for v in args.resolution.lower().split("x"))
    sms, clock = ((args.sms, args.clock_mhz)
                  if args.sms and args.clock_mhz else card_rate())
    rep = report(width, height, args.batch, sms, clock)
    if args.json:
        print(json.dumps(rep))
        return
    print(f"{width}x{height}, batch {args.batch}: int32 "
          f"{rep['int32_tops']:.2f} Tops/s ({INT32_OPS_PER_CLK_PER_SM}/clk/SM"
          f" x {sms} SMs x {clock:.0f} MHz), memory {rep['hbm_tb_s']:.2f} "
          f"TB/s")
    print(f"{'class':>7} {'kernel':>14} {'nCU':>7} {'G ops':>8} {'MB':>7} "
          f"{'bound ms':>9} by")
    for r in rep["classes"]:
        print(f"{r['class']:>7} {r['kernel']:>14} {r['n_cu']:>7} "
              f"{r['ops'] / 1e9:>8.2f} {r['bytes'] / 1e6:>7.1f} "
              f"{r['bound_ms']:>9.4f} {r['bound_by']}")
    print(f"all classes: {rep['bound_ms']:.4f} ms ({rep['bound_by']})")


if __name__ == "__main__":
    main()
