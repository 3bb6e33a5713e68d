#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (vvc_mip_gpu_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel library from csrc/ (one nvcc per source, started
together), prints each kernel's ptxas registers and spills (and fails if
any cost kernel spills) and its static SASS instruction mix
(utils/sass.py), holds every kernel against its plain PyTorch version on
the card (bit-exact: every value is an integer; all 17 cost classes on
noise and smooth frames at 1920x1080 and 608x192, both output regimes, a
halo row, a distinct reference, saturated frames: all 1023, all 0, a
0/1023 checkerboard, and outputs off 16-byte alignment), and drives each
of the port's paths through the entry points a user calls, all at
1920x1080:

- the main path, MipCostEngine(1920, 1080,
  max_performance=True).compute_batch over 16 distinct uniform-random
  frames resident on the card, timed, then each class's launch timed
  beside its bound;
- (a) the reduced-prediction kernel against its plain version on the
  reduced boundaries of every class of a noise and a smooth frame, timed
  beside its bound and a cuBLAS fp32 product of the same shapes;
- (b) the 8 filters x every KernelIdx on the card against the CPU, timed
  at batch 16;
- (c) the filtered regime with the full report (SAD, SATD, minSadHad)
  over 16 frames, against the plain path on frames 0-1, timed;
- (d) the inspect readback on the card (through the reduced-prediction
  kernel) against the host's, for groups of each SizeId, edge CTUs and a
  filtered reference;
- (e) the port's CLI in-process (filtered, full report, target CTU, two
  frames) into a temporary directory, its CSVs checked against the card's
  costs and deleted.

Every path runs with the launch counters set to 0 just before it and read
just after, and fails unless each of its kernels launched.  It prints one
JSON line of per-kernel numbers, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any mismatch, CUDA error or missing
launch exits non-zero with no result.
"""

from __future__ import annotations

import contextlib
import filecmp
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MAIN_W, MAIN_H, MAIN_BATCH = 1920, 1080, 16
TIMED_ITERS = 10
# The most 32-bit integer results an SM can produce per clock at compute
# capability 9.0: its 4 schedulers each issue one 32-lane warp instruction
# a clock.  Two pipes share that rate, 64 results per clock each (CUDA C++
# Programming Guide, arithmetic instruction throughput table): multiply-add
# on the FMA pipe, add, logic, shift, abs and min/max on the integer pipe.
# A kernel whose multiply-adds and other integer operations overlap can
# beat 64 per clock, and the 4x4 cost kernel does.
INT32_OPS_PER_CLK_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SOURCE = "vvc_mip_gpu_tpu_torch/csrc/mip_cost.cu"
PRED_SOURCE = "vvc_mip_gpu_tpu_torch/csrc/mip_pred.cu"
FILTER = ("filterFrame_2d_int_quarterCtu", 2)  # the filtered-regime phases
CLI_TARGET_CTU = 5
# every cost launch, each redesigned for Hopper (one thread per CU for
# 4x4; 8 threads per (CU, mode) for 64x64; one thread per (CU, mode,
# 4-column strip) for the other 15 classes): ptxas must report no spills
REDESIGNED = (
    "mip_cost_sid0_kernel<4,4>",
    *(f"mip_cost_sid1_kernel<{w},{h}>" for w, h in (
        (32, 4), (4, 32), (16, 4), (4, 16), (8, 8), (8, 4), (4, 8))),
    *(f"mip_cost_sid2_kernel<{w},{h}>" for w, h in (
        (64, 64), (32, 32), (32, 16), (16, 32), (32, 8), (8, 32), (16, 16),
        (16, 8), (8, 16))))


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


def csv_shape(path) -> tuple[str, int]:
    """(header, data rows) of a CSV file."""
    with open(path) as f:
        header = f.readline().rstrip("\n")
    return header, int(np.count_nonzero(np.fromfile(path, np.uint8) == 10)) - 1


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


def pred_inputs(frame16: torch.Tensor) -> dict:
    """{SizeId: (red_t, red_l)}: the reduced boundaries of every CU of
    every class of one [H, W] int16 frame on the card, int32 [BS, nCU]."""
    from vvc_mip_gpu_tpu_torch.ops import mip_ops as ops
    from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans, padded_extent

    hp, wp = padded_extent(MAIN_W, MAIN_H)
    ref_pad = ops.pad_reference(frame16, frame16[0], hp, wp)
    parts: dict[int, tuple[list, list]] = {0: ([], []), 1: ([], []),
                                           2: ([], [])}
    for cplan in class_plans(MAIN_W, MAIN_H):
        sid, bs = cplan.shape.size_id, cplan.shape.boundary_size
        for gp in cplan.groups:
            ref_t, ref_l = ops.gather_boundaries(ref_pad, gp, True)
            parts[sid][0].append(ops.reduce_boundary(ref_t, bs))
            parts[sid][1].append(ops.reduce_boundary(ref_l, bs))
    return {sid: tuple(torch.cat(p, 1).to(torch.int32).contiguous()
                       for p in pair) for sid, pair in parts.items()}


def phase_pred(noise16, smooth16, int_rate: float, failures) -> dict:
    """(a) mip_reduced_pred against its plain version on the card, every
    SizeId, a noise and a smooth frame; then its times over one frame's
    CUs beside the bound and a cuBLAS fp32 product of the same shapes."""
    from vvc_mip_gpu_tpu_torch.mip_weights import matrices, weights_from_numpy
    from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred as kernel

    max_err = 0
    inputs = {}
    for label, frame16 in (("noise", noise16), ("smooth", smooth16)):
        inputs[label] = pred_inputs(frame16)
        for sid, (red_t, red_l) in inputs[label].items():
            got = kernel(red_t, red_l, sid)
            want = kernel.plain(red_t, red_l, sid)
            torch.cuda.synchronize()
            err = (int((got.int() - want.int()).abs().max())
                   if got.shape == want.shape else -1)
            max_err = max(max_err, abs(err))
            if err or got.dtype != torch.int16:
                failures.append(f"pred {label} SizeId {sid}: max_abs_err "
                                f"{err}, {got.dtype} {tuple(got.shape)}")
            print(f"check pred {label} SizeId {sid} ({red_t.shape[1]} CUs, "
                  f"out {tuple(got.shape)}): max_abs_err {err}")

    weights = weights_from_numpy(matrices(), noise16.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 reference
    torch.backends.cudnn.allow_tf32 = False
    row = {"ms": 0.0, "plain_ms": 0.0, "ops": 0, "bytes": 0, "cublas": 0.0,
           "sizeid_ms": {}}
    for sid, (red_t, red_l) in inputs["noise"].items():
        m, s, c = weights[sid].shape
        n = red_t.shape[1]
        ms = Timer(lambda: kernel(red_t, red_l, sid), 20).ms
        plain_ms = Timer(lambda: kernel.plain(red_t, red_l, sid), 3).ms
        mat = torch.cat([weights[sid], weights[sid]]).reshape(
            2 * m * s, c).float()
        off = torch.cat([red_t, red_l]).float()
        cublas_ms = Timer(lambda: torch.matmul(mat, off), 20).ms
        # what the function needs: per output sample C multiply-adds (C - 1
        # for SizeId 2, whose first offset is 0), shift, add, two clamps;
        # per (CU, wing) 3C for the offsets and their sum
        macs = c - 1 if sid == 2 else c
        ops = n * (2 * m * s * (macs + 4) + 2 * 3 * c)
        nbytes = (red_t.numel() + red_l.numel()) * 4 + weights[sid].numel() * 4
        nbytes += 2 * m * s * n * 2
        bound = max(ops / int_rate, nbytes / HBM_BYTES_PER_S) * 1e3
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["ops"] += ops
        row["bytes"] += nbytes
        row["cublas"] += cublas_ms
        row["sizeid_ms"][str(sid)] = round(ms, 4)
        print(f"pred SizeId {sid}: {n} CUs, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, cuBLAS fp32 [{2 * m * s}x{c}]x[{c}x{n}] "
              f"{cublas_ms:.4f} ms, bound {bound:.4f} ms ({ops / 1e9:.3f} G "
              f"int ops, {nbytes / 1e6:.1f} MB)", flush=True)
    row["max_err"] = max_err
    return row


def phase_filters(batch: torch.Tensor, failures) -> None:
    """(b) filter_frames on the card against the CPU, all 8 variants x
    every KernelIdx, on a noise and a smooth frame; then each variant's
    time on the batch (KernelIdx 2)."""
    from vvc_mip_gpu_tpu_torch.constants import AVAILABLE_FILTERS
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames

    rng = np.random.default_rng(3)
    cpu = torch.from_numpy(np.stack([
        rng.integers(0, 1024, (MAIN_H, MAIN_W)),
        synthetic_frames(1, MAIN_W, MAIN_H, seed=4)[0]]).astype(np.int32))
    card = cpu.to(batch.device)
    pairs = [(ftype, kidx) for ftype in AVAILABLE_FILTERS
             for kidx in range(3 if "5x5" in ftype else 5)]
    bad = [f"{ftype}[{kidx}]" for ftype, kidx in pairs
           if not torch.equal(filter_frames(card, ftype, kidx).cpu(),
                              filter_frames(cpu, ftype, kidx))]
    if bad:
        failures.append(f"filters differ on the card from the CPU: {bad}")
    print(f"check filters: {len(pairs)} variant/KernelIdx pairs, card vs "
          f"CPU: {'bit-exact' if not bad else 'DIFFER ' + str(bad)}")
    for ftype in AVAILABLE_FILTERS:
        ms = Timer(lambda: filter_frames(batch, ftype, 2), 5).ms
        print(f"filter {ftype}[2]: {ms:.3f} ms per batch of "
              f"{batch.shape[0]}", flush=True)


def phase_filtered_full(frames: torch.Tensor, failures) -> None:
    """(c) the filtered regime with the full report, driven through the
    entry points: compute_batch(frames, filter_frames(frames, ...))."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, MipCostEngine, class_runs)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

    engine = MipCostEngine(MAIN_W, MAIN_H)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    refs = filter_frames(frames, *FILTER)
    costs = engine.compute_batch(frames, refs)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    print(f"filtered full-report path launches: {launches}")
    if list(launches.values()) != [1, 7, 9]:
        failures.append(f"filtered path launches {launches}, want 1/7/9")
    shape = (frames.shape[0], num_ctus(MAIN_W, MAIN_H)[2], PER_CTU)
    if any(t is None or tuple(t.shape) != shape or t.dtype != torch.int32
           for t in (costs.sad, costs.satd, costs.min_sad_had)):
        failures.append("filtered path: cost tensors of the wrong shape")
        return
    f16 = frames[:2].to(torch.int16).contiguous()
    r16 = refs[:2].to(torch.int16).contiguous()
    plain = [torch.full((2, *shape[1:]), -1, dtype=torch.int32,
                        device=frames.device) for _ in range(2)]
    for run in class_runs(MAIN_W, MAIN_H, frames.device):
        run.kernel.plain(f16, r16, r16[:, 0].contiguous(), True, run.plan,
                         run.table, run.weights, plain)
    want = (plain[0], plain[1], torch.minimum(2 * plain[0], plain[1]))
    bad = [name for name, got, exp in zip(
        ("SAD", "SATD", "minSadHad"),
        (costs.sad, costs.satd, costs.min_sad_had), want)
        if not torch.equal(got[:2], exp)]
    if bad:
        failures.append(f"filtered path {bad} differ from the plain path "
                        f"on frames 0-1")
    print("check filtered full-report path: SAD, SATD, minSadHad of frames "
          f"0-1 vs the plain path: {'equal' if not bad else 'DIFFER'}")
    filt = Timer(lambda: filter_frames(frames, *FILTER), TIMED_ITERS).ms
    search = Timer(lambda: engine.compute_batch(frames, refs),
                   TIMED_ITERS).ms
    both = Timer(lambda: engine.compute_batch(
        frames, filter_frames(frames, *FILTER)), TIMED_ITERS).ms
    b = frames.shape[0]
    print(f"filtered full report: {both:.3f} ms per batch of {b} "
          f"({both / b:.4f} ms/frame, {b * 1e3 / both:.2f} frames/s); "
          f"filter {filt:.3f} ms, search {search:.3f} ms", flush=True)


def phase_inspect(failures) -> int:
    """(d) inspect_ctu on the card (through mip_reduced_pred) against the
    host's, groups of each SizeId, edge CTUs and a filtered reference.
    Returns the kernel's launches in this path."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.inspect import inspect_ctu
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred

    rng = np.random.default_rng(7)
    noise = rng.integers(0, 1024, (MAIN_H, MAIN_W)).astype(np.int32)
    smooth = synthetic_frames(1, MAIN_W, MAIN_H, seed=8)[0].astype(np.int32)
    filtered = filter_frames(torch.from_numpy(smooth)[None].cuda(),
                             *FILTER)[0]
    cols, rows, n_ctu = num_ctus(MAIN_W, MAIN_H)
    bottom = n_ctu - cols  # the partial bottom row at 1080p (56 of 128)
    # (frame, reference, group, CTU): groups of every SizeId, interior,
    # top-row, bottom-row and corner CTUs, original and filtered refs
    cases = [(noise, None, 6, cols + 2), (noise, None, 0, n_ctu - 1),
             (noise, None, 46, bottom), (noise, None, 32, bottom + 7),
             (smooth, filtered, 20, (rows // 2) * cols + 4),
             (smooth, filtered, 41, n_ctu - 1), (smooth, filtered, 29, 3),
             (smooth, filtered, 46, bottom + 10),
             (smooth, filtered, 27, bottom + 5)]
    torch.cuda.synchronize()
    mip_reduced_pred.launches = 0
    results = [inspect_ctu(frame, ctu, group, ref_frame=ref,
                           from_engine=True)
               for frame, ref, group, ctu in cases]
    torch.cuda.synchronize()
    launches = mip_reduced_pred.launches
    for (frame, ref, group, ctu), dev in zip(cases, results):
        host = inspect_ctu(frame, ctu, group, ref_frame=ref)
        bad = [k for k in host if k != "group" and not (
            k in dev and np.array_equal(dev[k], host[k]))]
        if sorted(dev) != sorted(host) or bad:
            failures.append(f"inspect group {group} CTU {ctu}: {bad}")
        shapes = ", ".join(f"{k} {v.shape}" for k, v in dev.items()
                           if k != "group")
        print(f"check inspect group {group} ({dev['group']}) CTU {ctu}"
              f"{' filtered ref' if ref is not None else ''}: "
              f"{'bit-exact' if not bad else 'DIFFERS in ' + str(bad)} "
              f"({shapes})")
    print(f"inspect path: mip_reduced_pred launches {launches} for "
          f"{len(cases)} readbacks", flush=True)
    if launches != len(cases):
        failures.append(f"inspect path launched mip_reduced_pred "
                        f"{launches} times, want {len(cases)}")
    return launches


def phase_cli(card: str, failures) -> None:
    """(e) the port's CLI in-process, into a temporary directory: the
    filtered regime, full report, a target CTU, two frames in one chunk.
    Checks each CSV's header and row count, and frame 0's decisions CSV
    and the target-CTU CSV byte for byte against a fresh export of the
    card's costs; the files are deleted afterwards."""
    from vvc_mip_gpu_tpu_torch import cli
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.io.export import (
        export_decisions_csv, export_target_ctu_csv)
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, MipCostEngine)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

    n_ctu = num_ctus(MAIN_W, MAIN_H)[2]
    header = "POC,CTU,cuSizeName,W,H,CU,X,Y,Mode,SAD,SATD,minSadHad"
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "cli_")
        args = ["-f", "2", "-s", f"{MAIN_W}x{MAIN_H}", "--Synthetic",
                "--FullDistortion", "--FilterType", FILTER[0],
                "--KernelIdx", str(FILTER[1]), "--TargetCTU",
                str(CLI_TARGET_CTU), "--BatchFrames", "2", "-l", prefix]
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        with open(Path(tmp) / "stdout.txt", "w") as out, \
                contextlib.redirect_stdout(out):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in KERNELS}
        text = (Path(tmp) / "stdout.txt").read_text()
        report = text[text.index("Stage timing report:"):].rstrip()
        print(f"CLI {' '.join(args[:-2])}: rc {rc}, {wall:.2f} s wall, "
              f"launches {launches} ({card})")
        print(report)
        if rc != 0 or list(launches.values()) != [1, 7, 9]:
            failures.append(f"CLI rc {rc}, launches {launches}")
        frames = torch.from_numpy(synthetic_frames(
            2, MAIN_W, MAIN_H).astype(np.int32)).cuda()
        costs = MipCostEngine(MAIN_W, MAIN_H).compute_batch(
            frames, filter_frames(frames, *FILTER))
        sad, satd, msh = (t.cpu().numpy() for t in (
            costs.sad, costs.satd, costs.min_sad_had))
        for name, rows in (("mip_decisions_poc0.csv", n_ctu * PER_CTU),
                           ("mip_decisions_poc1.csv", n_ctu * PER_CTU),
                           (f"target_ctu{CLI_TARGET_CTU}.csv", 2 * PER_CTU)):
            path = Path(prefix + name)
            got_header, got_rows = csv_shape(path)
            ok = got_header == header and got_rows == rows
            print(f"check CLI {name}: {got_rows} rows, "
                  f"{path.stat().st_size / 1e6:.1f} MB, header "
                  f"{'ok' if got_header == header else repr(got_header)}: "
                  f"{'ok' if ok else 'WRONG'}", flush=True)
            if not ok:
                failures.append(f"CLI {name}: header or rows wrong")
        # the export layer alone: the card's costs of frame 0 and of the
        # target CTU, written again, must give the CLI's files byte for
        # byte (the exports equal the JAX package's bytes on the CPU)
        again = Path(tmp) / "again.csv"
        t0 = time.perf_counter()
        export_decisions_csv(again, msh[0], MAIN_W, sad=sad[0],
                             satd=satd[0], poc=0)
        export_s = time.perf_counter() - t0
        same = filecmp.cmp(again, prefix + "mip_decisions_poc0.csv",
                           shallow=False)
        print(f"export_decisions_csv of frame 0 (full report, "
              f"{n_ctu * PER_CTU} rows): {export_s:.2f} s; equals the "
              f"CLI's file: {same}", flush=True)
        export_target_ctu_csv(
            again, list(msh[:, CLI_TARGET_CTU]), MAIN_W, CLI_TARGET_CTU,
            sad_per_frame=list(sad[:, CLI_TARGET_CTU]),
            satd_per_frame=list(satd[:, CLI_TARGET_CTU]), pocs=[0, 1])
        same_target = filecmp.cmp(
            again, f"{prefix}target_ctu{CLI_TARGET_CTU}.csv", shallow=False)
        print(f"export_target_ctu_csv of the card's costs equals the CLI's "
              f"file: {same_target}", flush=True)
        if not (same and same_target):
            failures.append("CLI decisions or target CSV differs from the "
                            "export of the card's costs")


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
    from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred
    from vvc_mip_gpu_tpu_torch.utils.sass import (
        describe, instruction_mix, kernel_name)

    card = smi("name,power.limit")
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {props.name} "
          f"SMs {props.multi_processor_count}", flush=True)

    # ---- 1. build the kernels from csrc/ (never a library left by an
    # earlier run in this tree), one nvcc per source, all at once
    for name in _build.LIBRARIES:
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = _build.build_libraries()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{', '.join(path.name for path, _ in built.values())}")
    failures: list[str] = []
    resources: dict[str, dict] = {}
    for _, log in built.values():
        kernel = "?"
        for line in log.splitlines():  # ptxas -v: per-kernel resources
            if m := re.search(r"Function properties for (\S+)", line):
                kernel = kernel_name(m[1])
            elif "spill" in line or "registers" in line:
                print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
                res = resources.setdefault(kernel, {})
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line):
                    res["spill_bytes"] = int(m[1]) + int(m[2])
                if m := re.search(r"Used (\d+) registers", line):
                    res["registers"] = int(m[1])
    for kernel in REDESIGNED:
        res = resources.get(kernel, {})
        print(f"ptxas {kernel}: {res}")
        if res.get("spill_bytes") != 0:
            failures.append(f"{kernel}: ptxas spills {res}")
    try:  # the static instruction mix of the cost kernels
        mix = instruction_mix(built["mip_cost"][0])
        for kernel, counts in mix.items():
            print(f"sass {kernel}: {describe(counts)}")
    except (RuntimeError, subprocess.CalledProcessError) as err:
        print(f"sass: not measured ({err})")
    print(flush=True)

    max_err = {k.name: 0 for k in KERNELS}

    def sentinel(shape, misaligned=False):
        """An int32 output filled with -1; with ``misaligned``, a view one
        element into a flat buffer (off 16-byte alignment)."""
        n = int(np.prod(shape))
        if not misaligned:
            return torch.full(shape, -1, dtype=torch.int32, device=dev)
        flat = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        return flat[1:].view(shape)

    def check(label, frames, refs, halo, is_top, width, height,
              max_performance, misaligned=False):
        """Every class: kernel vs plain version on the same CUDA tensors,
        both into sentinel-filled outputs (so an entry the kernel fails to
        write shows as a difference; ``misaligned`` kernel outputs reach
        the kernels' scalar stores); then the engine's compute_ext on the
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
            outs_k = [sentinel(shape, misaligned) for _ in range(n_out)]
            if misaligned:
                assert all(o.data_ptr() % 16 == 4 for o in outs_k)
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
    # saturated content: the prediction clamp at both ends and the largest
    # differences and SATDs (all-1023, all-0, a 0/1023 checkerboard)
    yy, xx = np.mgrid[:MAIN_H, :MAIN_W]
    fr = torch.from_numpy(np.stack([
        np.full((MAIN_H, MAIN_W), 1023), np.zeros((MAIN_H, MAIN_W), np.int64),
        (yy + xx) % 2 * 1023]).astype(np.int32)).to(dev)
    for mp in (True, False):
        check(f"1920x1080 saturated mp={int(mp)}", fr, fr, fr[:, 0], True,
              MAIN_W, MAIN_H, mp)
    # outputs one int32 off 16-byte alignment: the scalar store fallback
    fr = frames_for(MAIN_W, MAIN_H)
    check("1920x1080 misaligned-outputs", fr, fr, fr[:, 0], True, MAIN_W,
          MAIN_H, False, misaligned=True)
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
                           "classes": {}, "class_bounds": {}}
                  for k in KERNELS}
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
        agg["class_bounds"][f"{s.width}x{s.height}"] = round(bound, 4)
        print(f"class {s.width}x{s.height} {run.kernel.name}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
              f"({ops / 1e9:.2f} G int ops, {nbytes / 1e6:.1f} MB), "
              f"{ms / bound:.2f}x the bound, 1 launch per batch", flush=True)

    # ---- 4-8. the prediction kernel, the filters, the filtered full
    # report, the inspect readback and the CLI
    noise16 = f16[0]
    smooth16 = torch.from_numpy(synthetic_frames(
        1, MAIN_W, MAIN_H, seed=5)[0].astype(np.int16)).to(dev)
    pred = phase_pred(noise16, smooth16, int_rate, failures)
    phase_filters(frames, failures)
    phase_filtered_full(frames, failures)
    pred_launches = phase_inspect(failures)
    phase_cli(card, failures)
    if failures:
        print("FAILED:", *failures, sep="\n  ", file=sys.stderr)
        return 1

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
            "classes_bound_ms": agg["class_bounds"],
            "shape": f"{MAIN_BATCH}x{MAIN_W}x{MAIN_H}"})
    t_ops = pred["ops"] / int_rate * 1e3
    t_bytes = pred["bytes"] / HBM_BYTES_PER_S * 1e3
    rows.append({
        "name": "mip_reduced_pred", "route": "cuda", "source": PRED_SOURCE,
        "replaces": mip_reduced_pred.replaces, "launches": pred_launches,
        "max_abs_err": pred["max_err"], "ms": round(pred["ms"], 4),
        "plain_ms": round(pred["plain_ms"], 3),
        "bound_ms": round(max(t_ops, t_bytes), 4),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "bit_exact": pred["max_err"] == 0,
        "sizeid_ms": pred["sizeid_ms"],
        "cublas_fp32_product_ms": round(pred["cublas"], 4),
        "shape": f"all CUs of one {MAIN_W}x{MAIN_H} frame, SizeId 0-2"})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
