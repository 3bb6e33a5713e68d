#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (vvc_mip_gpu_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the cost kernels from csrc/, holds every kernel instantiation
against its plain PyTorch version on the card (bit-exact: every value is an
integer), drives the port's main path — MipCostEngine(1920, 1080,
max_performance=True).compute_batch over 16 distinct uniform-random frames
resident on the card — checks that every kernel launched in that run,
times it, and prints one JSON line of per-kernel numbers, the card's
name and power limit, and last {"ok": true, "device": {...}}.  Any
mismatch, CUDA error or missing launch exits non-zero with no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_W, MAIN_H, MAIN_BATCH = 1920, 1080, 16
TIMED_ITERS = 10
# Integer results per clock per SM for 32-bit add, multiply-add, shift,
# compare and logic at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table).
INT32_OPS_PER_CLK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SOURCE = "vvc_mip_gpu_tpu_torch/csrc/mip_cost.cu"


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def class_ops(h: int, w: int, r: int, two_m: int, n_cu: int) -> int:
    """Integer operations one class needs for one frame: the per-class op
    model of tools/roofline.py:44-58 (diff, SAD, butterflies, SATD
    abs+acc per sample; ~4 ops per upsampled sample; the prediction
    epilogue and per-mode epilogue)."""
    per_sample = 1 + 2 + 4 + 2
    up_ops = 0
    if r < w:
        up_ops += 4 * r * w
    if r < h or r < w:
        up_ops += 4 * h * w
    ops_mode = per_sample * h * w + up_ops + 4 * r * r + 6
    return n_cu * two_m * ops_mode


class Timer:
    """Mean device milliseconds of ``fn`` over ``iters`` launches."""

    def __init__(self, fn, iters: int, warmup: int = 1):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        self.ms = start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, MipCostEngine, class_runs, compute_ext)
    from vvc_mip_gpu_tpu_torch.ops import _build
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

    card = smi("name,power.limit")
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {props.name} "
          f"SMs {props.multi_processor_count}", flush=True)

    # ---- 1. build the kernels from csrc/ (never a library left by an
    # earlier run in this tree)
    _build.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    lib_path, log = _build.build_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    kernel = "?"
    for line in log.splitlines():  # ptxas -v: per-kernel resources
        if m := re.search(r"Function properties for \S*(mip_cost_sid\d)"
                          r"_kernelILi(\d+)ELi(\d+)E", line):
            kernel = f"{m[1]} {m[2]}x{m[3]}"
        elif "spill" in line or "registers" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    print(flush=True)

    failures: list[str] = []
    max_err = {k.name: 0 for k in KERNELS}

    def check(label, frames, refs, halo, is_top, width, height,
              max_performance):
        """Every class: kernel vs plain version on the same CUDA tensors,
        both into sentinel-filled outputs (so an entry the kernel fails to
        write shows as a difference); then the engine's compute_ext on the
        card against the plain results of all classes."""
        share = refs is frames
        frames = frames.to(torch.int16).contiguous()
        refs = frames if share else refs.to(torch.int16).contiguous()
        halo = halo.to(torch.int16).contiguous()
        n_ctu = num_ctus(width, height)[2]
        shape = (frames.shape[0], n_ctu, PER_CTU)
        n_out = 1 if max_performance else 2
        plain_all = [torch.full(shape, -1, dtype=torch.int32, device=dev)
                     for _ in range(n_out)]
        for run in class_runs(width, height, dev):
            outs_k = [torch.full(shape, -1, dtype=torch.int32, device=dev)
                      for _ in range(n_out)]
            outs_p = [torch.full(shape, -1, dtype=torch.int32, device=dev)
                      for _ in range(n_out)]
            args = (frames, refs, halo, is_top, run.plan, run.table,
                    run.weights)
            run.kernel(*args, outs_k)
            run.kernel.plain(*args, outs_p)
            run.kernel.plain(*args, plain_all)
            torch.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(outs_k, outs_p))
            name = f"{run.plan.shape.width}x{run.plan.shape.height}"
            max_err[run.kernel.name] = max(max_err[run.kernel.name], err)
            if err:
                failures.append(f"{label} {name}: max_abs_err {err}")
            print(f"check {label} {run.kernel.name} {name}: "
                  f"max_abs_err {err}")
        sad, satd, msh = compute_ext(frames, refs, halo, is_top, width,
                                     height, max_performance)
        if max_performance:
            pairs = [(msh, plain_all[0])]
        else:
            p_sad, p_satd = plain_all
            pairs = [(sad, p_sad), (satd, p_satd),
                     (msh, torch.minimum(2 * p_sad, p_satd))]
        ok = all(torch.equal(a, b) for a, b in pairs)
        if not ok:
            failures.append(f"{label}: compute_ext differs from plain")
        print(f"check {label} compute_ext vs plain: "
              f"{'equal' if ok else 'DIFFERS'}", flush=True)

    # ---- 2. per-kernel, per-class checks on the card
    rng = np.random.default_rng(1)

    def frames_for(width, height):
        return torch.from_numpy(np.stack([
            rng.integers(0, 1024, (height, width)),
            synthetic_frames(1, width, height, seed=2)[0]]).astype(
                np.int32)).to(dev)

    for width, height in ((MAIN_W, MAIN_H), (608, 192)):
        fr = frames_for(width, height)
        for mp in (True, False):
            check(f"{width}x{height} mp={int(mp)}", fr, fr, fr[:, 0], True,
                  width, height, mp)
    fr = frames_for(MAIN_W, MAIN_H)
    halo = torch.from_numpy(rng.integers(0, 1024, (2, MAIN_W))).to(dev)
    check("1920x1080 is_top=0 halo", fr, fr, halo, False, MAIN_W, MAIN_H,
          False)
    ref = torch.from_numpy(rng.integers(0, 1024, (2, MAIN_H, MAIN_W))).to(dev)
    check("1920x1080 distinct-ref", fr, ref, ref[:, 0], True, MAIN_W, MAIN_H,
          True)
    if failures:
        print("FAILED:", *failures, sep="\n  ", file=sys.stderr)
        return 1

    # ---- 3. the main path
    engine = MipCostEngine(MAIN_W, MAIN_H, max_performance=True)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1024, size=(MAIN_BATCH, MAIN_H, MAIN_W), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    costs = engine.compute_batch(frames)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    want = {"mip_cost_sid0": 1, "mip_cost_sid1": 7, "mip_cost_sid2": 9}
    print(f"main path launches: {launches}")
    if launches != want:
        failures.append(f"main path launches {launches}, want {want}")
    msh = costs.min_sad_had
    n_ctu = num_ctus(MAIN_W, MAIN_H)[2]
    if (costs.sad is not None or tuple(msh.shape) != (MAIN_BATCH, n_ctu,
                                                      PER_CTU)
            or msh.dtype != torch.int32 or int(msh.min()) < 0):
        failures.append(f"main path output {tuple(msh.shape)} {msh.dtype}")
    # the first two frames against the plain versions
    f16 = frames[:2].to(torch.int16).contiguous()
    plain = torch.full((2, n_ctu, PER_CTU), -1, dtype=torch.int32,
                       device=dev)
    runs = class_runs(MAIN_W, MAIN_H, dev)
    for run in runs:
        run.kernel.plain(f16, f16, f16[:, 0].contiguous(), True, run.plan,
                         run.table, run.weights, [plain])
    if not torch.equal(msh[:2], plain):
        failures.append("main path minSadHad differs from the plain path")
    if failures:
        print("FAILED:", *failures, sep="\n  ", file=sys.stderr)
        return 1
    print("main path output: bit-exact with the plain path on frames 0-1",
          flush=True)

    batch = Timer(lambda: engine.compute_batch(frames), TIMED_ITERS, 2).ms
    print(f"main path: {batch:.3f} ms per batch of {MAIN_BATCH}, "
          f"{batch / MAIN_BATCH:.4f} ms/frame, "
          f"{MAIN_BATCH * 1e3 / batch:.2f} frames/s ({card})")

    # per-class kernel and plain-version times at the main path's shapes
    f16 = frames.to(torch.int16).contiguous()
    halo16 = f16[:, 0].contiguous()
    out = torch.empty((MAIN_BATCH, n_ctu, PER_CTU), dtype=torch.int32,
                      device=dev)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = (INT32_OPS_PER_CLK_PER_SM * props.multi_processor_count
                * clock_mhz * 1e6)
    print(f"bound rates: int32 {int_rate / 1e12:.2f} Tops/s "
          f"({INT32_OPS_PER_CLK_PER_SM}/clk/SM x "
          f"{props.multi_processor_count} SMs x {clock_mhz:.0f} MHz), "
          f"memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    per_kernel = {k.name: {"ms": 0.0, "plain_ms": 0.0, "ops": 0, "bytes": 0,
                           "classes": {}} for k in KERNELS}
    for run in runs:
        s = run.plan.shape
        args = (f16, f16, halo16, True, run.plan, run.table, run.weights,
                [out])
        ms = Timer(lambda: run.kernel(*args), 5).ms
        plain_ms = Timer(lambda: run.kernel.plain(*args), 1).ms
        n_cu = run.table.shape[0]
        ops = MAIN_BATCH * class_ops(s.height, s.width, s.reduced_pred_size,
                                     s.total_modes, n_cu)
        nbytes = (f16.numel() * 2 + run.table.numel() * 4
                  + run.weights.numel() * 4
                  + MAIN_BATCH * n_cu * s.total_modes * 4)
        bound = max(ops / int_rate, nbytes / HBM_BYTES_PER_S) * 1e3
        agg = per_kernel[run.kernel.name]
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["ops"] += ops
        agg["bytes"] += nbytes
        agg["classes"][f"{s.width}x{s.height}"] = round(ms, 4)
        print(f"class {s.width}x{s.height} {run.kernel.name}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
              f"({ops / 1e9:.2f} G int ops, {nbytes / 1e6:.1f} MB)",
              flush=True)

    rows = []
    for k in KERNELS:
        agg = per_kernel[k.name]
        t_ops = agg["ops"] / int_rate * 1e3
        t_bytes = agg["bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": k.name, "route": "cuda", "source": SOURCE,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max_err[k.name], "ms": round(agg["ms"], 4),
            "plain_ms": round(agg["plain_ms"], 2),
            "bound_ms": round(max(t_ops, t_bytes), 4),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "bit_exact": max_err[k.name] == 0,
            "classes_ms": agg["classes"],
            "shape": f"{MAIN_BATCH}x{MAIN_W}x{MAIN_H}"})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
