#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (vvc_mip_gpu_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel library from csrc/ (one nvcc per source, started
together), prints each kernel's ptxas registers and spills (and fails if
any cost kernel spills) and its static SASS instruction mix
(utils/sass.py), holds every kernel against its plain PyTorch version on
the card (bit-exact: every value is an integer; all 17 cost classes on
noise and smooth frames at 1920x1080, 608x192 and the reference's other
sizes 416x240, 832x480 and 1280x720, both output regimes, a halo row, a
distinct reference, saturated frames: all 1023, all 0, a 0/1023
checkerboard, and outputs off 16-byte alignment), and drives each of the
port's paths through the entry points a user calls, at 1920x1080 unless
said otherwise:

- the main path, MipCostEngine(1920, 1080,
  max_performance=True).compute_batch over 16 distinct uniform-random
  frames resident on the card, timed, then each class's launch timed
  beside its bound;
- (a) the reduced-prediction kernel against its plain version on the
  reduced boundaries of every class of a noise and a smooth frame, timed
  beside its bound and a cuBLAS fp32 product of the same shapes;
- (b) the 8 filters x every KernelIdx on the card (csrc/mip_filter.cu,
  one launch a call) against the CPU and against the port's NumPy golden
  filters (golden/filters_golden.py) at 1920x1080, on a noise and a
  smooth frame, each variant's kernel timed at batch 16 beside its bound
  and its plain version;
- (c) the filtered regime with the full report (SAD, SATD, minSadHad)
  over 16 frames, compute_batch(frames, filter_frames(frames, ...)) with
  its launches counted from 0 (one filter kernel, 1 / 7 / 9 cost
  kernels), against the plain path on frames 0-1, timed;
- (d) the inspect readback on the card (through the reduced-prediction
  kernel) against the host's, for groups of each SizeId, edge CTUs and a
  filtered reference;
- (e) the port's CLI in-process (filtered, full report, target CTU, two
  frames) into a temporary directory, its CSVs, written by the C writer
  (csrc/io_native.c), checked against the card's costs and frame 0's
  against the numpy writer's bytes, both writers timed;
- (f) the multi-device engines on this one card: the sharded engine
  (meshes (1, 1) and (2, 2) on the main path's batch, and (1, 2) in the
  filtered full report, whose bands meet at a filtered halo row) against
  MipCostEngine on the edge-padded and on the true frames; the latency
  engine on one frame with 1 part and with 4 parts on 4 streams, both
  regimes, each also read through a readback ring as the CLI's
  --LatencyMode step reads it (one part: each SizeId's block of columns
  copied while the next SizeId searches); the CLI's latency path, which
  reads back through the pinned readback ring, and two CLI processes (gloo on localhost) with (e)'s
  flags, whose CSVs must equal (e)'s byte for byte (then all are
  deleted); the JAX package's two multi-process cases at 256x192 (one
  process owning no frame under a filter and a target CTU; 3 frames over
  two processes with --MeshSpace 2), each byte-equal to a single-process
  run with the same flags; each timed (ms per batch, single-frame latency
  host to host and by step, the readback into new pageable memory and
  into the ring, CLI wall time);
- (g) the C frame-CSV writer and reader against the numpy ones on 16
  frames, byte for byte and sample for sample, timed;
- (h) the port's power tracer (tools/power_tracer.py, nvidia-smi as the
  meter) on the CLI at 1920x1080, max-performance, 1 and 2 frames, and
  its energy analysis (tools/compute_energy.py): every stage marker
  paired, a power sample inside the search, joules per stage and frame;
- the roofline tool's per-class bounds (tools/roofline.py, the op model
  of every bound here) against the ones this run reports;
- (i) bench and 4K: one uniform-random and one smooth 3840x2160 frame
  through MipCostEngine, full report and max-performance, whole tensors
  (out-of-frame CUs included) against the plain path, tolerance 0; then
  the port's bench (python -m vvc_mip_gpu_tpu_torch.bench) as a child
  process in each of its modes and at 3840x2160, each JSON line echoed,
  and its 1080p headline held against the main path's ms per batch;
- (j) the port's in-context profiler (tools/profile_incontext.py) at
  1920x1080 with --loo (e2e, each class alone, their sum, each class left
  out) on one frame and on a batch of 16, then --batch 1, 4, 8, 16, 32
  and --batch 16 --class 8x16, every run's launches per call held to the
  classes it searched; the host's CPU filtering sweep
  (tools/profile_cpu_filtering.py, 1 to the host's CPU count workers,
  every band bit-equal to the whole frame) beside the card's filter ms
  per frame for the same four variants;
- (l) the reference's other three sizes, 416x240, 832x480 and 1280x720
  (partial right CTU columns of 32 and 64 samples, partial bottom rows
  of 112, 96 and 80): (l.1) the 32 filter pairs on the card against the
  golden filters, on a noise and a smooth frame, one kernel launch each; (l.2) the main path
  over 16 distinct frames, frames 0-1 against the plain path and frame
  0's minSadHad against the golden model; (l.3) the full report and
  (l.4) the filtered full report (FILTER and a 1-D filter, the golden
  model fed by the golden filters) against the golden model; the golden
  model on a spawned pool while the card works, on valid CUs, masks
  equal; (l.5) the CLI at each size (filtered, full report, two frames,
  a target CTU; one frame a chunk at the two larger sizes) against the
  card's costs, and at 416x240 its decisions CSVs against CSVs of the
  golden model's costs through the port's decisions diff
  (tools/diff_decisions.py) on in-frame rows; then each size's main path
  timed beside its 17 kernels and their bounds (and at batch 64 at
  416x240), and the port's bench at each size (headline, --filtered;
  --batch 64 at 416x240) as child processes;
- (m) 3840x2160 (17 CTU rows, the last of 112 samples) through every
  entry point, the golden model on a spawned pool for two frames while
  the card works: (m.1) the 32 filter pairs against the golden filters
  on a noise and a smooth frame, one kernel launch each; (m.2) the main path over 16 distinct
  frames, frames 0-1 against the plain path and frame 0's minSadHad
  against the golden model; (m.3) the full report of the noise frame and
  (m.4) the filtered full report of the CLI's POC 0 (FILTER on the card)
  against the golden model (valid CUs, masks equal) and the latter whole
  against the plain path; (m.5) the CLI (filtered, full report, two
  frames, --TargetCTU of the bottom-right CTU) against the card's costs
  byte for byte, each 4K decisions CSV deleted once compared, and the
  target CTU's POC-0 rows against the golden model's export (byte for
  byte on in-frame CUs); (m.6) the CLI's --LatencyMode on one frame
  against MipCostEngine's export; (m.7) the sharded engine (1, 2)
  filtered and (2, 2) on 4 frames, and the latency engine with 1 and 4
  parts in both regimes, called and through the ring, against
  MipCostEngine, and the one-part ring path against the golden model;
  (m.8) the inspect readback at the bottom-right, bottom-left and an interior CTU; then, the pool
  gone, (m.9) the main path timed beside its 17 kernels and their
  bounds, the filter kernel on a batch of 16 (FILTER) beside its bound
  and its plain version, and the port's bench at 4K with --latency and
  --window reference as child processes;
- (k) the card's costs against the port's own golden cost oracles, on
  valid CUs (the golden model clips out-of-frame CU coordinates, the
  port replicates edges), in int64, each validity mask against the
  golden model's: the golden model (golden/reference_model.py), its 47
  groups a frame on a spawned process pool while the card works, against
  (k.1a) the main path's own minSadHad of frame 0, (k.1b) the full report
  of frame 0 (launches 1 / 7 / 9), (k.1d) the CLI's latency path in
  SizeId parts on frame 0 (both regimes) and (k.2) the full report of a
  smooth frame filtered on the card, the golden model fed by
  golden/filters_golden.py; the scalar oracle (golden/scalar_oracle.py)
  against (k.3) 1128 (CU, mode) entries of phase (i)'s two 3840x2160
  frames (every group: the top-left CTU, the top row, the left and the
  last column, the partial bottom row of 112, an interior CTU; a normal
  and a transposed mode) and (k.1c) ~560 of frame 0 at 1920x1080, the
  card's and the golden model's.  It runs last, where no phase times the
  host, and prints the golden model's seconds a frame and its workers.

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
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

MAIN_W, MAIN_H, MAIN_BATCH = 1920, 1080, 16
UHD_W, UHD_H = 3840, 2160  # phases (i), (k.3) and (m)
# phase (i): the bench's modes, in order; the 3840x2160 runs need the
# 3840x2160 check to have passed
BENCH_RUNS = ([], ["--filtered"], ["--window", "reference"],
              ["--window", "r1"], ["--with-export"], ["--latency"],
              ["--resolution", f"{UHD_W}x{UHD_H}"],
              ["--resolution", f"{UHD_W}x{UHD_H}", "--filtered"])
# the headline's frames/s against the main path's: the salt XOR and the
# count take ~15 % of a 1080p batch (the count 1.6 ms), a compile or a
# sync per batch far more
HEADLINE_FLOOR = 0.8
TIMED_ITERS = 10
FRAME_IO_FRAMES = 16  # phase (g)
ENERGY_FRAMES = 2  # phase (h): the tracer's sweep, 1..ENERGY_FRAMES
# the pageable readback of the same 52.8 MB before the ring (PERF.md §5)
EARLIER_PAGEABLE_READBACK_MS = 27.941
SOURCE = "vvc_mip_gpu_tpu_torch/csrc/mip_cost.cu"
PRED_SOURCE = "vvc_mip_gpu_tpu_torch/csrc/mip_pred.cu"
FILTER_SOURCE = "vvc_mip_gpu_tpu_torch/csrc/mip_filter.cu"
FILTER = ("filterFrame_2d_int_quarterCtu", 2)  # the filtered-regime phases
CLI_TARGET_CTU = 5
# phase (l): the reference's other three frame sizes (constants.py
# AVAILABLE_RES; common-test-condition classes D, C and E), the 1-D
# filter held beside FILTER, the CLI's target CTU there, and the bench's
# runs: the headline and --filtered at each size, and a larger batch at
# the smallest, where one batch of 16 is about one 1080p frame of work
REF_SIZES = ((416, 240), (832, 480), (1280, 720))
REF_FILTERS = (FILTER, ("filterFrame_1d_float_5x5", 1))
REF_TARGET_CTU = 3
REF_LARGE_BATCH = 64
REF_BENCH_RUNS = (
    *(extra for w, h in REF_SIZES for extra in (
        ["--resolution", f"{w}x{h}"],
        ["--resolution", f"{w}x{h}", "--filtered"])),
    ["--resolution", "{}x{}".format(*REF_SIZES[0]), "--batch",
     str(REF_LARGE_BATCH)])
# phase (m): 3840x2160 through every entry point.  The bench's 4K runs
# that (i) does not make (no --with-export: 16 frames of 4K CSV are ~45
# GB); the sharded (2, 2) mesh's frames; the bytes a decisions CSV row
# takes at most there, for the free-space check
UHD_BENCH_RUNS = (["--resolution", f"{UHD_W}x{UHD_H}", "--latency"],
                  ["--resolution", f"{UHD_W}x{UHD_H}", "--window",
                   "reference"])
UHD_MESH_FRAMES = 4
CSV_ROW_BYTES = 64
# phase (f.3): the JAX package's two multi-process cases
# (tests/test_multiprocess.py:178 and :80-81) at 256x192
MULTI_PROCESS_CASES = {
    "one process owning no frame": [
        "-f", "1", "-s", "256x192", "--Synthetic", "--FilterType", FILTER[0],
        "--KernelIdx", str(FILTER[1]), "--TargetCTU", "1"],
    "3 frames, --MeshSpace 2": [
        "-f", "3", "-s", "256x192", "--Synthetic", "--MeshSpace", "2"]}
# phase (j): the sweep on one frame, where a class alone is host-bound,
# and on the main path's batch; the batch sweep; one class in a batch
INCONTEXT_RUNS = (["--loo"], ["--loo", "--batch", str(MAIN_BATCH)],
                  *(["--batch", str(b)] for b in (1, 4, 8, 16, 32)),
                  ["--batch", "16", "--class", "8x16"])
# every cost launch, each redesigned for Hopper (one thread per CU for
# 4x4; 8 threads per (CU, mode) for 64x64; one thread per (CU, mode,
# 4-column strip) for the other 15 classes): ptxas must report no spills
# a cost kernel's name in a profiler trace: its class's width and height
COST_KERNEL = re.compile(r"mip_cost_sid\d_kernel<(\d+), ?(\d+)>")
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


def device_times(fn, iters: int) -> dict[str, float]:
    """{kernel: device ms per call of ``fn``} over ``iters`` calls after a
    warm-up call, from torch.profiler's CUDA activity: the card's own
    spans of every kernel, whoever launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def plain_costs(frames16: torch.Tensor, refs16: torch.Tensor, width: int,
                height: int, n_out: int) -> list[torch.Tensor]:
    """Every class's plain version over int16 [B, H, W] frames and
    references on the card (the references' top rows as halo): [minSadHad]
    (``n_out`` 1) or [SAD, SATD] (2), each int32 [B, nCTU, 97840]."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, class_runs

    dev = frames16.device
    shape = (frames16.shape[0], num_ctus(width, height)[2], PER_CTU)
    outs = [torch.full(shape, -1, dtype=torch.int32, device=dev)
            for _ in range(n_out)]
    halo = refs16[:, 0].contiguous()
    for run in class_runs(width, height, dev):
        run.kernel.plain(frames16, refs16, halo, True, run.plan, run.table,
                         run.weights, outs)
    return outs


def class_times(frames16: torch.Tensor, width: int, height: int,
                int_rate: float, failures, where: str = "") -> dict:
    """Each class's kernel and plain-version times (CUDA events) over the
    int16 [B, H, W] ``frames16`` on the card, beside its bound from the
    op model (tools/roofline.py), each printed.  Returns {kernel: {"ms",
    "plain_ms", "ops", "bytes", "classes": {class: ms}, "class_bounds":
    {class: bound ms}}}."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, class_runs
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS
    from vvc_mip_gpu_tpu_torch.tools import roofline

    batch = frames16.shape[0]
    halo16 = frames16[:, 0].contiguous()
    out = torch.empty((batch, num_ctus(width, height)[2], PER_CTU),
                      dtype=torch.int32, device=frames16.device)
    per_kernel = {k.name: {"ms": 0.0, "plain_ms": 0.0, "ops": 0, "bytes": 0,
                           "classes": {}, "class_bounds": {}}
                  for k in KERNELS}
    # the op model's work per class, in the runs' order
    work = roofline.class_work(width, height, batch)
    for run, cw in zip(class_runs(width, height, frames16.device), work):
        s = run.plan.shape
        args = (frames16, frames16, halo16, True, run.plan, run.table,
                run.weights, [out])
        ms = Timer(lambda: run.kernel(*args), 5).ms
        plain_ms = Timer(lambda: run.kernel.plain(*args), 1).ms
        if (cw["class"] != f"{s.width}x{s.height}"
                or cw["n_cu"] != run.table.shape[0]
                or cw["kernel"] != run.kernel.name):
            failures.append(f"roofline class {cw} is not run {s}")
        ops, nbytes = cw["ops"], cw["bytes"]
        bound = roofline.bound(ops, nbytes, int_rate)[0]
        agg = per_kernel[run.kernel.name]
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["ops"] += ops
        agg["bytes"] += nbytes
        agg["classes"][f"{s.width}x{s.height}"] = round(ms, 4)
        agg["class_bounds"][f"{s.width}x{s.height}"] = round(bound, 4)
        print(f"class {s.width}x{s.height} {run.kernel.name}{where}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
              f"({ops / 1e9:.2f} G int ops, {nbytes / 1e6:.1f} MB), "
              f"{ms / bound:.2f}x the bound, 1 launch per batch", flush=True)
    return per_kernel


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
    from vvc_mip_gpu_tpu_torch.tools import roofline

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
        bound = roofline.bound(ops, nbytes, int_rate)[0]
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


def filter_pairs() -> list[tuple[str, int]]:
    """The 8 filter variants x every KernelIdx: 32 pairs."""
    from vvc_mip_gpu_tpu_torch.constants import AVAILABLE_FILTERS

    return [(ftype, kidx) for ftype in AVAILABLE_FILTERS
            for kidx in range(3 if "5x5" in ftype else 5)]


def filters_differ(host: np.ndarray, dev: torch.device,
                   against_cpu: bool) -> list[str]:
    """filter_frames on the card over the [N, H, W] ``host`` frames, every
    pair of filter_pairs, against the port's NumPy golden filters (the
    oracle, on a thread per host CPU: NumPy releases the GIL) and, with
    ``against_cpu``, against filter_frames on the CPU.  Returns what
    differs."""
    from vvc_mip_gpu_tpu_torch.golden.filters_golden import filter_frame
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.tools.profile_cpu_filtering import host_cpus

    cpu = torch.from_numpy(host.astype(np.int32))
    card = cpu.to(dev)

    def oracle_equal(pair, got: np.ndarray) -> bool:
        return all(np.array_equal(filter_frame(frame, *pair), out)
                   for frame, out in zip(host, got))

    bad, futures = [], {}
    with ThreadPoolExecutor(host_cpus()) as pool:
        for ftype, kidx in filter_pairs():
            before = filter_frames.launches
            got = filter_frames(card, ftype, kidx).cpu()
            if filter_frames.launches != before + 1:
                bad.append(f"{ftype}[{kidx}]: "
                           f"{filter_frames.launches - before} kernel "
                           f"launches, want 1")
            if against_cpu and not torch.equal(
                    got, filter_frames(cpu, ftype, kidx)):
                bad.append(f"{ftype}[{kidx}] vs the CPU")
            futures[f"{ftype}[{kidx}]"] = pool.submit(oracle_equal,
                                                      (ftype, kidx),
                                                      got.numpy())
        bad += [f"{name} vs the oracle" for name, f in futures.items()
                if not f.result()]
    return bad


def filter_timings(frames: torch.Tensor, pair: tuple[str, int],
                   int_rate: float, card: str, label: str) -> dict:
    """The filter kernel on the int32 [N, H, W] ``frames`` under ``pair``
    (CUDA events) beside its bound (a multiply and an add per tap, a
    rounding add and a division per sample; the int32 batch read once
    and the int32 result written once) and its plain version's ms on the
    card, and its output on ``frames`` against the plain version's.
    Returns {"ms", "plain_ms", "bound_ms", "bound_by", "bit_exact"}."""
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.tools import roofline

    ftype, kidx = pair
    k = 5 if "5x5" in ftype else 3
    taps = k * k if "2d" in ftype else 2 * k
    samples = frames.numel()
    bound_ms, bound_by = roofline.bound(samples * (2 * taps + 2),
                                        samples * 8, int_rate)
    ms = Timer(lambda: filter_frames(frames, ftype, kidx), TIMED_ITERS).ms
    plain_ms = Timer(lambda: filter_frames.plain(frames, ftype, kidx), 3).ms
    exact = torch.equal(filter_frames(frames, ftype, kidx),
                        filter_frames.plain(frames, ftype, kidx))
    t = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "bit_exact": exact}
    n, h, w = frames.shape
    print(f"({label}) filter {ftype}[{kidx}] {w}x{h} batch {n}: kernel "
          f"{ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f} %), "
          f"plain {plain_ms:.3f} ms, "
          f"{'bit-exact' if exact else 'DIFFERS from'} the plain version "
          f"({card})", flush=True)
    return t


def phase_filters(batch: torch.Tensor, int_rate: float, card: str,
                  failures) -> dict:
    """(b) filter_frames on the card against the CPU and against the
    port's NumPy golden filters, all 8 variants x every KernelIdx, on a
    noise and a smooth frame, one kernel launch a call; then each
    variant's kernel on the batch (KernelIdx 2) beside its bound and its
    plain version (filter_timings).  Returns FILTER's timings."""
    from vvc_mip_gpu_tpu_torch.constants import AVAILABLE_FILTERS
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames

    rng = np.random.default_rng(3)
    host = np.stack([rng.integers(0, 1024, (MAIN_H, MAIN_W)),
                     synthetic_frames(1, MAIN_W, MAIN_H, seed=4)[0]])
    t0 = time.perf_counter()
    bad = filters_differ(host, batch.device, True)
    if bad:
        failures.append(f"filters differ on the card: {bad}")
    print(f"check filters {MAIN_W}x{MAIN_H}: {len(filter_pairs())} "
          f"variant/KernelIdx pairs x {len(host)} frames (noise, smooth), "
          f"card vs CPU and vs the NumPy golden filters: "
          f"{'bit-exact' if not bad else 'DIFFER ' + str(bad)} "
          f"({time.perf_counter() - t0:.1f} s)")
    times = {ftype: filter_timings(batch, (ftype, 2), int_rate, card, "b")
             for ftype in AVAILABLE_FILTERS}
    differ = [f for f, t in times.items() if not t["bit_exact"]]
    if differ:
        failures.append(f"filter timings (b): {differ} differ from the "
                        f"plain version")
    return times[FILTER[0]]


def phase_filtered_full(frames: torch.Tensor, failures) -> int:
    """(c) the filtered regime with the full report, driven through the
    entry points: compute_batch(frames, filter_frames(frames, ...)).
    Returns the filter kernel's launches in that run."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, MipCostEngine)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

    engine = MipCostEngine(MAIN_W, MAIN_H)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    filter_frames.launches = 0
    refs = filter_frames(frames, *FILTER)
    costs = engine.compute_batch(frames, refs)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    filter_launches = filter_frames.launches
    print(f"filtered full-report path launches: {launches}, "
          f"{filter_frames.name} {filter_launches}")
    if list(launches.values()) != [1, 7, 9] or filter_launches != 1:
        failures.append(f"filtered path launches {launches}, "
                        f"{filter_frames.name} {filter_launches}, want "
                        f"1/7/9 and 1")
    shape = (frames.shape[0], num_ctus(MAIN_W, MAIN_H)[2], PER_CTU)
    if any(t is None or tuple(t.shape) != shape or t.dtype != torch.int32
           for t in (costs.sad, costs.satd, costs.min_sad_had)):
        failures.append("filtered path: cost tensors of the wrong shape")
        return filter_launches
    plain = plain_costs(frames[:2].to(torch.int16).contiguous(),
                        refs[:2].to(torch.int16).contiguous(), MAIN_W,
                        MAIN_H, 2)
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
    return filter_launches


def phase_inspect(failures) -> int:
    """(d) inspect_ctu on the card (through mip_reduced_pred) against the
    host's, groups of each SizeId, edge CTUs and a filtered reference.
    Returns the kernel's launches in this path."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames

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
    return inspect_cases(cases, "", failures)


def inspect_cases(cases: list, where: str, failures) -> int:
    """inspect_ctu through mip_reduced_pred on the card for each (frame,
    reference or None, group, CTU) of ``cases``, against the host's
    readback; the kernel's launches must be one a readback.  Returns
    them."""
    from vvc_mip_gpu_tpu_torch.models.inspect import inspect_ctu
    from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred

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
            failures.append(f"inspect{where} group {group} CTU {ctu}: {bad}")
        shapes = ", ".join(f"{k} {v.shape}" for k, v in dev.items()
                           if k != "group")
        print(f"check inspect{where} group {group} ({dev['group']}) CTU "
              f"{ctu}{' filtered ref' if ref is not None else ''}: "
              f"{'bit-exact' if not bad else 'DIFFERS in ' + str(bad)} "
              f"({shapes})")
    print(f"inspect path{where}: mip_reduced_pred launches {launches} for "
          f"{len(cases)} readbacks", flush=True)
    if launches != len(cases):
        failures.append(f"inspect path{where} launched mip_reduced_pred "
                        f"{launches} times, want {len(cases)}")
    return launches


def phase_cli(card: str, tmp: str, failures) -> list[str]:
    """(e) the port's CLI in-process, into the directory ``tmp``: the
    filtered regime, full report, a target CTU, two frames in one chunk.
    Checks each CSV's header and row count, and frame 0's decisions CSV
    and the target-CTU CSV byte for byte against a fresh export of the
    card's costs.  The files stay for phase (f); returns the CLI's
    arguments but the output prefix."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.io.export import (
        export_decisions_csv, export_decisions_csv_plain,
        export_target_ctu_csv)
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, MipCostEngine)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames

    n_ctu = num_ctus(MAIN_W, MAIN_H)[2]
    header = "POC,CTU,cuSizeName,W,H,CU,X,Y,Mode,SAD,SATD,minSadHad"
    prefix = str(Path(tmp) / "cli_")
    args = ["-f", "2", "-s", f"{MAIN_W}x{MAIN_H}", "--Synthetic",
            "--FullDistortion", "--FilterType", FILTER[0],
            "--KernelIdx", str(FILTER[1]), "--TargetCTU",
            str(CLI_TARGET_CTU), "--BatchFrames", "2", "-l", prefix]
    (rc, wall, report), launches = count_launches(
        lambda: cli_in_process(args, Path(tmp) / "stdout.txt"))
    print(f"CLI {' '.join(args[:-2])}: rc {rc}, {wall:.2f} s wall, "
          f"launches {launches} ({card})")
    print(report)
    if rc != 0 or launches != [1, 7, 9]:
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
    # byte (the exports equal the JAX package's bytes on the CPU), and
    # the numpy writer, the C writer's oracle, the same bytes
    again = Path(tmp) / "again.csv"
    plain = Path(tmp) / "plain.csv"
    t0 = time.perf_counter()
    export_decisions_csv(again, msh[0], MAIN_W, sad=sad[0],
                         satd=satd[0], poc=0)
    export_s = time.perf_counter() - t0
    same = filecmp.cmp(again, prefix + "mip_decisions_poc0.csv",
                       shallow=False)
    t0 = time.perf_counter()
    export_decisions_csv_plain(plain, msh[0], MAIN_W, sad=sad[0],
                               satd=satd[0], poc=0)
    plain_s = time.perf_counter() - t0
    same_plain = filecmp.cmp(plain, again, shallow=False)
    mb = again.stat().st_size / 1e6
    plain.unlink()
    print(f"export_decisions_csv of frame 0 (full report, "
          f"{n_ctu * PER_CTU} rows, {mb:.1f} MB): C writer {export_s:.3f} s "
          f"({mb / export_s:.1f} MB/s), equals the CLI's file: {same}; "
          f"numpy writer {plain_s:.3f} s ({mb / plain_s:.1f} MB/s), "
          f"equals the C writer's bytes: {same_plain} ({card})", flush=True)
    if not same_plain:
        failures.append("the C and numpy decisions writers differ")
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
    again.unlink()
    return args[:-2]


def count_launches(fn):
    """(fn's result, [launches of mip_cost_sid0, 1, 2] during fn): the
    counters set to 0 just before, read just after a synchronize.  The
    filter kernel's counter is set to 0 too: ``filter_frames.launches``
    afterwards is its launches during fn."""
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    filter_frames.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [k.launches for k in KERNELS]


def differing(got, want, fields, valid=None) -> list[str]:
    """The fields of two FrameCosts that differ (on ``valid`` entries only
    when given), compared on the card."""
    bad = []
    for field in fields:
        a, b = getattr(got, field), getattr(want, field)
        a, b = a.to(b.device), b
        if a.shape != b.shape:
            bad.append(f"{field} shape {tuple(a.shape)} vs {tuple(b.shape)}")
        elif valid is None and not torch.equal(a, b):
            bad.append(f"{field} ({int((a != b).sum())} entries)")
        elif valid is not None and bool(((a != b) & valid).any()):
            bad.append(f"{field} ({int(((a != b) & valid).sum())} valid "
                       f"entries)")
    return bad


SHARDED_MESHES = ((1, 1, True), (2, 2, True), (1, 2, False))


def sharded_checks(frames: torch.Tensor, main_msh: torch.Tensor, width: int,
                   height: int, meshes, failures) -> dict:
    """ShardedMipCostEngine on this one card over ``frames`` for each
    (n_data, n_space, max_performance) of ``meshes`` (n_data x n_space
    shards on as many streams, real halo rows; in the filtered full report
    band s reads band s-1's last FILTERED row).  Each against
    MipCostEngine on the edge-padded frames (whole padded tensors) and on
    the true frames (valid CUs of the true CTUs; ``main_msh``, the main
    path's minSadHad of ``frames``, for max-performance), its mask against
    _validity_mask over the padded height and its launches against
    n_shards x (1, 7, 9).
    Returns {mesh: (engine, reference frames or None)}."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        FrameCosts, MipCostEngine, _validity_mask)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.parallel import ShardedMipCostEngine, make_mesh

    dev = frames.device
    valid = torch.from_numpy(_validity_mask(width, height)).to(dev)
    n_ctu = valid.shape[0]
    refs = filter_frames(frames, *FILTER)
    full_true = MipCostEngine(width, height).compute_batch(frames, refs)
    engines = {}
    for n_data, n_space, mp in meshes:
        name = (f"{width}x{height} ({n_data}, {n_space}) "
                f"{'max-performance' if mp else 'filtered full report'}")
        mesh = make_mesh(n_data, n_space, [dev] * (n_data * n_space))
        engine = ShardedMipCostEngine(width, height, mesh,
                                      max_performance=mp)
        ref = None if mp else refs
        engines[name] = engine, ref
        got, launches = count_launches(lambda: engine(frames, ref))
        n = n_data * n_space
        fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
        padded = MipCostEngine(width, engine.padded_height,
                               max_performance=mp).compute_batch(
            engine.pad_frames(frames),
            None if mp else engine.pad_frames(refs))
        bad = differing(got, padded, fields)
        del padded
        true = FrameCosts(None, None, main_msh, None) if mp else full_true
        got_true = FrameCosts(*(None if t is None else t[:, :n_ctu] for t in (
            got.sad, got.satd, got.min_sad_had)), None)
        bad += [f"true CTUs: {b}" for b in differing(got_true, true, fields,
                                                     valid)]
        mask_ok = np.array_equal(got.valid.cpu().numpy(), _validity_mask(
            width, height, engine.padded_height))
        if not mask_ok:
            bad.append("validity mask")
        if launches != [n, 7 * n, 9 * n]:
            bad.append(f"launches {launches}, want {[n, 7 * n, 9 * n]}")
        if bad:
            failures.append(f"sharded {name}: {bad}")
        print(f"check sharded {name}, {frames.shape[0]} frames padded to "
              f"{engine.padded_height} rows: launches {launches}; whole "
              f"padded tensors vs MipCostEngine on edge-padded frames, valid "
              f"CUs of the true CTUs vs MipCostEngine, mask: "
              f"{'bit-exact' if not bad else bad}", flush=True)
        del got, got_true
    return engines


def phase_sharded(frames: torch.Tensor, main_msh: torch.Tensor, card: str,
                  failures) -> dict:
    """(f.1) sharded_checks over the main path's batch for SHARDED_MESHES
    (the (1, 1) and (2, 2) meshes max-performance, the (1, 2) mesh in the
    filtered full report), then each timed.  Returns {mesh: ms per
    batch}."""
    times = {}
    for name, (engine, ref) in sharded_checks(
            frames, main_msh, MAIN_W, MAIN_H, SHARDED_MESHES,
            failures).items():
        ms = Timer(lambda: engine(frames, ref), TIMED_ITERS).ms
        times[name] = ms
        print(f"sharded {name}: {ms:.3f} ms per batch of {frames.shape[0]} "
              f"({card})", flush=True)
    return times


def median_ms(fn, runs: int = 10) -> float:
    """Median host-clock milliseconds of ``fn`` (which ends on the host)
    over ``runs`` runs after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def latency_checks(frame: np.ndarray, width: int, height: int,
                   dev: torch.device, parts, failures) -> dict:
    """LatencyMipCostEngine on one host frame with [dev] x n (n parts on
    n streams) for each n of ``parts``, max-performance on the original
    samples and the full report on the filtered reference: whole tensors
    against MipCostEngine(frame), one launch per class in all, the costs
    on the host; then the same through a readback ring, as the CLI's
    --LatencyMode step reads (with one part each SizeId's columns copied
    while the next SizeId searches; with several, one copy after the
    gather).  Returns {(n, max_performance): engine}."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.parallel.latency_engine import (
        LatencyMipCostEngine, PartedFrame)
    from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

    filtered = filter_frames(torch.from_numpy(frame)[None].to(dev),
                             *FILTER)[0].cpu().numpy()
    engines = {}
    for mp, ref in ((True, None), (False, filtered)):
        fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
        want = MipCostEngine(width, height, max_performance=mp)(frame, ref)
        for n_parts in parts:
            engine = LatencyMipCostEngine(width, height, [dev] * n_parts,
                                          max_performance=mp)
            engines[n_parts, mp] = engine
            ring = ReadbackRing()
            label = (f"{width}x{height} {n_parts} part(s), "
                     f"{'max-performance' if mp else 'filtered full report'}")
            engaged = []

            def through_ring():
                outs = engine.dispatch(frame, ref, ring)
                engaged.append(isinstance(outs, PartedFrame))
                return engine.assemble(outs, ring.read)

            for how, call in (("call", lambda: engine(frame, ref)),
                              ("ring", through_ring)):
                got, launches = count_launches(call)
                bad = differing(got, want, fields)
                if launches != [1, 7, 9]:
                    bad.append(f"launches {launches}, want [1, 7, 9]")
                if got.min_sad_had.device.type != "cpu":
                    bad.append("costs not on the host")
                if how == "ring" and engaged != [n_parts == 1]:
                    bad.append(f"SizeId parts engaged: {engaged}")
                if bad:
                    failures.append(f"latency {label} ({how}): {bad}")
                parted = how == "ring" and engaged == [True]
                print(f"check latency {label} ({how}"
                      f"{', SizeId parts' if parted else ''}): "
                      f"launches {launches}; whole tensors vs "
                      f"MipCostEngine(frame): "
                      f"{'bit-exact' if not bad else bad}", flush=True)
    return engines


def latency_ring_golden(frame: np.ndarray, width: int, height: int,
                        dev: torch.device, golden: dict, label: str) -> list:
    """The CLI's --LatencyMode step on one card (the one-part latency
    engine read through a readback ring in SizeId parts) on ``frame``'s
    original samples, full report and max-performance, against the golden
    model's costs of that frame (valid CUs, masks equal).  Returns what
    differs."""
    from vvc_mip_gpu_tpu_torch.parallel.latency_engine import (
        LatencyMipCostEngine)
    from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

    bad = []
    ring = ReadbackRing()
    for mp in (False, True):
        engine = LatencyMipCostEngine(width, height, [dev],
                                      max_performance=mp)
        got = engine.assemble(engine.dispatch(frame, None, ring), ring.read)
        fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
        bad += golden_differences(
            f"{label} {width}x{height} the latency path in SizeId parts, "
            f"{'max-performance' if mp else 'full report'}", golden,
            {f: getattr(got, f) for f in fields}, got.valid)
    return bad


def phase_latency(frame: np.ndarray, dev: torch.device, card: str,
                  failures) -> dict:
    """(f.2) latency_checks on one 1080p host frame with 1 part and with
    4.  Then single-frame latency, host frame to host arrays, median of
    10: MipCostEngine and both latency engines, max-performance.
    Returns {engine: ms}."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
    from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

    engines = latency_checks(frame, MAIN_W, MAIN_H, dev, (1, 4), failures)
    single = MipCostEngine(MAIN_W, MAIN_H, max_performance=True)
    ring = ReadbackRing()
    times = {"MipCostEngine": median_ms(
        lambda: single(frame).min_sad_had.cpu().numpy()),
        "MipCostEngine, readback ring": median_ms(
            lambda: ring.read(single(frame).min_sad_had))}
    for n_parts in (1, 4):
        engine = engines[n_parts, True]
        times[f"latency {n_parts} part(s)"] = median_ms(
            lambda: engine(frame).min_sad_had.numpy())
    for name, ms in times.items():
        print(f"single-frame latency {name}: {ms:.3f} ms median of 10, host "
              f"frame to host minSadHad ({card})", flush=True)
    # MipCostEngine's latency by step: the upload of the int32 frame, the
    # search on the card (CUDA events), the readback into new pageable
    # memory (what the engines do), into the CLI's readback ring (two
    # pinned buffers, reused) and, for reference, into one pinned buffer
    # allocated once
    on_card = torch.from_numpy(frame).to(dev)
    msh = single(on_card).min_sad_had
    pinned = torch.empty(msh.shape, dtype=msh.dtype, pin_memory=True)

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    steps = {
        "upload": median_ms(synced(lambda: torch.from_numpy(frame).to(dev))),
        "search (device)": Timer(lambda: single(on_card), TIMED_ITERS).ms,
        "readback, pageable": median_ms(lambda: msh.cpu()),
        "readback, ring": median_ms(lambda: ring.read(msh)),
        "readback, pinned": median_ms(synced(
            lambda: pinned.copy_(msh, non_blocking=True)))}
    print(f"single-frame latency of MipCostEngine by step "
          f"({msh.numel() * 4 / 1e6:.1f} MB out): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items())
          + f" ({card}); the pageable readback read "
          f"{EARLIER_PAGEABLE_READBACK_MS} ms before the ring (PERF.md)",
          flush=True)
    times.update({f"step {k}": v for k, v in steps.items()})
    return times


def cli_in_process(args: list[str], log: Path):
    """(rc, wall seconds, stage report) of the port's CLI run in this
    process, its output into ``log``."""
    from vvc_mip_gpu_tpu_torch import cli

    t0 = time.perf_counter()
    with open(log, "w") as out, contextlib.redirect_stdout(out):
        rc = cli.main(args)
    wall = time.perf_counter() - t0
    text = log.read_text()
    return rc, wall, text[text.index("Stage timing report:"):].rstrip()


def phase_cli_latency(cli_args: list[str], tmp: str, card: str,
                      failures) -> float:
    """(f.3) the CLI's latency path (--LatencyMode: one frame a chunk,
    each read back into the pinned readback ring while the writer thread
    exports the previous one) with phase (e)'s flags: its CSVs must equal
    (e)'s byte for byte.  Returns its wall seconds."""
    prefix = str(Path(tmp) / "lat_")
    (rc, wall, report), launches = count_launches(lambda: cli_in_process(
        cli_args + ["--LatencyMode", "-l", prefix], Path(tmp) / "lat.txt"))
    names = ("mip_decisions_poc0.csv", "mip_decisions_poc1.csv",
             f"target_ctu{CLI_TARGET_CTU}.csv")
    bad = [name for name in names
           if not filecmp.cmp(prefix + name, str(Path(tmp) / "cli_") + name,
                              shallow=False)]
    for name in names:
        Path(prefix + name).unlink(missing_ok=True)
    if rc or bad or launches != [2, 14, 18]:
        failures.append(f"CLI --LatencyMode: rc {rc}, launches {launches}, "
                        f"files differing from (e)'s: {bad}")
    print(f"CLI {' '.join(cli_args)} --LatencyMode (readback ring): rc {rc}, "
          f"{wall:.2f} s wall, launches {launches}; CSVs equal (e)'s byte for "
          f"byte: {not bad} ({card})\n{report}", flush=True)
    return wall


def phase_cli_processes(cli_args: list[str], tmp: str, card: str,
                        failures) -> float:
    """(f.3) two CLI processes on this card, joined through gloo on a
    free localhost port, with phase (e)'s flags: the union of their
    decisions CSVs and process 0's target-CTU CSV must equal (e)'s files
    byte for byte.  Returns the wall seconds of the two."""
    from vvc_mip_gpu_tpu_torch.parallel.distributed import launch_cli

    prefix = str(Path(tmp) / "mp_")
    t0 = time.perf_counter()
    try:
        outs = launch_cli(cli_args + ["-l", prefix], 2, timeout=300)
    except RuntimeError as err:
        failures.append(f"two-process CLI: {str(err)[-3000:]}")
        return float("nan")
    wall = time.perf_counter() - t0
    for i, out in enumerate(outs):
        report = out[out.index("Stage timing report:"):].rstrip()
        print(f"two-process CLI, process {i}:\n{report}")
    bad = [name for name in ("mip_decisions_poc0.csv",
                             "mip_decisions_poc1.csv",
                             f"target_ctu{CLI_TARGET_CTU}.csv")
           if not filecmp.cmp(prefix + name, str(Path(tmp) / "cli_") + name,
                              shallow=False)]
    if bad:
        failures.append(f"two-process CLI files differ from (e)'s: {bad}")
    print(f"two-process CLI {' '.join(cli_args)} --NumProcesses 2: "
          f"{wall:.2f} s wall; CSVs equal (e)'s byte for byte: "
          f"{not bad} ({card})", flush=True)
    return wall


def phase_cli_process_cases(tmp: str, card: str, failures) -> dict:
    """(f.3) the two multi-process cases of the JAX package's tests
    (tests/test_multiprocess.py), at 256x192 on this card: one process
    owning no frame under a filter and a target CTU, and 3 frames over two
    processes on a (1, 2) mesh each.  Each case's files must equal a
    single-process CLI run's with the same flags, byte for byte.  Returns
    {case: wall seconds of the two processes}."""
    from vvc_mip_gpu_tpu_torch.parallel.distributed import launch_cli

    walls = {}
    for name, args in MULTI_PROCESS_CASES.items():
        case = Path(tempfile.mkdtemp(dir=tmp))
        one, two = case / "one", case / "two"
        for d in (one, two):
            d.mkdir()
        rc, _, _ = cli_in_process(args + ["-l", str(one / "c_")],
                                  case / "stdout.txt")
        t0 = time.perf_counter()
        try:
            launch_cli(args + ["-l", str(two / "c_")], 2, timeout=300)
        except RuntimeError as err:
            failures.append(f"two-process CLI, {name}: {str(err)[-3000:]}")
            continue
        finally:
            walls[name] = time.perf_counter() - t0
        files = sorted(p.name for p in one.iterdir())
        bad = [] if files == sorted(p.name for p in two.iterdir()) else [
            "the file sets differ"]
        bad += [f for f in files if not filecmp.cmp(one / f, two / f,
                                                    shallow=False)]
        if rc or not files or bad:
            failures.append(f"two-process CLI, {name}: single-process rc "
                            f"{rc}, files {files}, differing {bad}")
        print(f"two-process CLI, {name} ({' '.join(args)}): "
              f"{walls[name]:.2f} s wall; {len(files)} files ({files}) equal "
              f"the single-process run's byte for byte: {not bad and not rc} "
              f"({card})", flush=True)
    return walls


def phase_frame_io(tmp: str, card: str, failures) -> None:
    """(g) the C frame-CSV writer and reader (csrc/io_native.c) against
    the numpy ones: 16 synthetic frames written by both must be byte
    equal; read back by both from frame 0 and from frame 5 they must
    give the frames.  Each timed."""
    from vvc_mip_gpu_tpu_torch.io import frames as fio

    frames = fio.synthetic_frames(FRAME_IO_FRAMES, MAIN_W, MAIN_H, seed=11)
    paths = {"C": Path(tmp) / "frames_c.csv",
             "numpy": Path(tmp) / "frames_numpy.csv"}
    times = {}
    for name, write in (("C", fio.write_frames_csv),
                        ("numpy", fio.write_frames_csv_plain)):
        t0 = time.perf_counter()
        write(paths[name], frames)
        times[f"write {name}"] = time.perf_counter() - t0
    bad = [] if filecmp.cmp(paths["C"], paths["numpy"], shallow=False) else [
        "the written files differ"]
    mb = paths["C"].stat().st_size / 1e6
    for start in (0, 5):
        n = FRAME_IO_FRAMES - start
        for name, read in (("C", fio.read_frames_csv),
                           ("numpy", fio.read_frames_csv_plain)):
            t0 = time.perf_counter()
            got = read(paths["C"], MAIN_W, MAIN_H, n, start=start)
            times[f"read {name} start={start}"] = time.perf_counter() - t0
            if not np.array_equal(got, frames[start:]):
                bad.append(f"{name} reader from frame {start}")
    for path in paths.values():
        path.unlink()
    if bad:
        failures.append(f"frame CSV I/O: {bad}")
    print(f"check frame CSV I/O, {FRAME_IO_FRAMES} frames {MAIN_W}x{MAIN_H} "
          f"({mb:.1f} MB): C and numpy writers byte-equal, C and numpy "
          f"readers from frames 0 and 5 equal the frames: "
          f"{'ok' if not bad else bad}; seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" ({card})", flush=True)


def phase_energy(tmp: str, card: str, failures) -> dict:
    """(h) the port's power tracer (nvidia-smi as the meter) on the CLI at
    1920x1080, max-performance, synthetic frames, for 1..ENERGY_FRAMES
    frames, and its energy analysis.  Every START marker must have its
    FINISH and a power sample must fall inside the ENQUEUE KERNELS
    window.  Returns {frames: joules per frame}."""
    from vvc_mip_gpu_tpu_torch.tools import compute_energy, power_tracer

    per_frame = {}
    for n in range(1, ENERGY_FRAMES + 1):
        prefix = str(Path(tmp) / f"energy_f{n}_")
        try:
            log, power = power_tracer.run_once(
                ["-s", f"{MAIN_W}x{MAIN_H}", "-f", str(n), "--Synthetic",
                 "-l", prefix], power_tracer.NVIDIA_SMI, prefix, 0.0)
        except RuntimeError as err:
            failures.append(f"power tracer, {n} frame(s): {str(err)[-2000:]}")
            continue
        finally:
            for csv in Path(tmp).glob(f"energy_f{n}_mip_decisions*"):
                csv.unlink()
        lines = Path(log).read_text().splitlines()
        power_lines = Path(power).read_text().splitlines()
        marks = [re.match(r"(START|FINISH) (.+),", line) for line in lines]
        starts = sorted(m[2] for m in marks if m and m[1] == "START")
        finishes = sorted(m[2] for m in marks if m and m[1] == "FINISH")
        samples = compute_energy.parse_power(power_lines)
        kernels = compute_energy.parse_markers(lines).get("ENQUEUE KERNELS",
                                                          [])
        inside = sum(a <= t <= b for t, _ in samples for a, b in kernels)
        report = compute_energy.analyze(lines, power_lines)
        bad = []
        if starts != finishes or not starts:
            bad.append(f"markers START {starts} FINISH {finishes}")
        if not inside:
            bad.append(f"no power sample inside ENQUEUE KERNELS {kernels}")
        if report.get("frames") != n:
            bad.append(f"frames {report.get('frames')}")
        if bad:
            failures.append(f"energy, {n} frame(s): {bad}")
            continue
        per_frame[n] = report["energy_per_frame_j"]
        stages = ", ".join(f"{k} {v['time_s'] * 1e3:.1f} ms {v['energy_j']:.2f}"
                           f" J" for k, v in report["stages"].items())
        print(f"energy, {n} frame(s) {MAIN_W}x{MAIN_H} max-performance: "
              f"{len(samples)} power samples ({inside} inside ENQUEUE "
              f"KERNELS), {len(starts)} marker pairs; active window "
              f"{report['active_window_s']:.3f} s, {report['avg_power_w']:.1f}"
              f" W, {report['energy_j']:.2f} J, "
              f"{report['energy_per_frame_j']:.2f} J per frame; per stage: "
              f"{stages} ({card})", flush=True)
    return per_frame


def phase_roofline(per_kernel: dict, card: str, failures) -> None:
    """The roofline tool's per-class bounds, with the rates it reads from
    the card itself, against the bounds this run reported."""
    from vvc_mip_gpu_tpu_torch.tools import roofline

    rep = roofline.report(MAIN_W, MAIN_H, MAIN_BATCH, *roofline.card_rate())
    bad = []
    for row in rep["classes"]:
        mine = per_kernel[row["kernel"]]["class_bounds"][row["class"]]
        print(f"roofline tool {row['class']} ({row['kernel']}): "
              f"{row['ops'] / 1e9:.2f} G ops, {row['bytes'] / 1e6:.1f} MB, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); this run "
              f"{mine:.4f} ms")
        if round(row["bound_ms"], 4) != mine:
            bad.append(row["class"])
    print(f"roofline tool: {rep['int32_tops']:.2f} Tops/s int32, "
          f"{rep['hbm_tb_s']:.2f} TB/s, all classes {rep['bound_ms']:.4f} ms "
          f"({rep['bound_by']}); equal to this run's bounds: {not bad} "
          f"({card})", flush=True)
    if bad:
        failures.append(f"roofline tool bounds differ for {bad}")


def uhd_frames() -> np.ndarray:
    """The two 3840x2160 frames of phases (i) and (k): uniform-random
    noise and a smooth frame, int32 [2, H, W]."""
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames

    return np.stack([
        np.random.default_rng(13).integers(0, 1024, (UHD_H, UHD_W)),
        synthetic_frames(1, UHD_W, UHD_H, seed=14)[0]]).astype(np.int32)


def phase_uhd(dev: torch.device, failures) -> bool:
    """(i.1) 3840x2160 on the card: a uniform-random and a smooth frame
    through MipCostEngine.compute_batch with the full report (SAD, SATD,
    minSadHad), then max-performance; whole tensors, out-of-frame CUs
    included, against the plain path, tolerance 0, one launch per class
    in each.  Returns whether all held."""
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, FrameCosts, MipCostEngine)

    frames = torch.from_numpy(uhd_frames()).to(dev)
    n_ctu = num_ctus(UHD_W, UHD_H)[2]
    f16 = frames.to(torch.int16).contiguous()
    plain = plain_costs(f16, f16, UHD_W, UHD_H, 2)
    want = FrameCosts(plain[0], plain[1],
                      torch.minimum(2 * plain[0], plain[1]), None)
    bad = []
    for mp in (False, True):
        costs, launches = count_launches(lambda: MipCostEngine(
            UHD_W, UHD_H, max_performance=mp).compute_batch(frames))
        fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
        diff = differing(costs, want, fields)
        if launches != [1, 7, 9]:
            diff.append(f"launches {launches}, want [1, 7, 9]")
        label = "max-performance" if mp else "full report"
        print(f"check {UHD_W}x{UHD_H} {label}, noise and smooth frames "
              f"({n_ctu} CTUs, {2 * n_ctu * PER_CTU} entries a field): "
              f"launches {launches}; whole tensors vs the plain path: "
              f"{'bit-exact' if not diff else diff}", flush=True)
        bad += [f"{label}: {d}" for d in diff]
        del costs
    if bad:
        failures.append(f"{UHD_W}x{UHD_H}: {bad}")
    return not bad


def bench_child(extra: list[str], failures) -> dict | None:
    """The port's bench as a child process with the flags ``extra``, on
    this card; its JSON line echoed on a line of its own.  The run fails
    on a nonzero exit, an error, a value <= 0 or cost kernel launches not
    in the proportion 1 / 7 / 9.  Returns its record, None if it failed."""
    label = " ".join(extra) or "(headline)"
    env = {k: v for k, v in os.environ.items() if k != "VVC_MIP_PLATFORM"}
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vvc_mip_gpu_tpu_torch.bench", *extra],
        cwd=Path(__file__).resolve().parent, env=env,
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    for line in lines:
        print(line)
    rec = json.loads(lines[-1]) if lines else {}
    launches = list(rec.get("launches", {}).values())
    bad = []
    if r.returncode or len(lines) != 1 or "error" in rec:
        bad.append(f"rc {r.returncode}, {len(lines)} JSON lines, "
                   f"error {rec.get('error')}: {r.stderr[-2000:]}")
    elif not rec["value"] > 0:
        bad.append(f"value {rec['value']}")
    elif not (len(launches) == 3 and launches[0] > 0
              and launches[1:] == [7 * launches[0], 9 * launches[0]]):
        bad.append(f"launches {rec.get('launches')}")
    print(f"bench {label}: rc {r.returncode}, {wall:.1f} s wall"
          f"{'' if not bad else ', FAILED ' + str(bad)}", flush=True)
    if bad:
        failures.append(f"bench {label}: {bad}")
        return None
    return rec


def phase_bench(main_ms: float, frames: torch.Tensor, msh: torch.Tensor,
                uhd_ok: bool, card: str, failures) -> None:
    """(i.2) the port's bench as a child process in each mode of
    BENCH_RUNS, on this card (bench_child); the 1080p headline fails
    below HEADLINE_FLOOR x the main path's frames/s of this run.  First,
    what the headline's window adds to each batch of the main path (the
    salt XOR and the count of the costs), timed here on the main path's
    ``frames`` and minSadHad ``msh``."""
    out = torch.empty_like(frames)
    salts = torch.arange(frames.shape[0], dtype=frames.dtype,
                         device=frames.device).view(-1, 1, 1)
    xor_ms = Timer(lambda: torch.bitwise_xor(frames, salts, out=out),
                   TIMED_ITERS).ms
    count_ms = Timer(lambda: torch.count_nonzero(msh), TIMED_ITERS).ms
    print(f"bench window parts per batch of {frames.shape[0]}: main path "
          f"{main_ms:.3f} ms + salt XOR {xor_ms:.3f} ms + count_nonzero of "
          f"{msh.numel() * 4 / 1e6:.1f} MB {count_ms:.3f} ms = "
          f"{main_ms + xor_ms + count_ms:.3f} ms ({card})", flush=True)
    del out
    torch.cuda.empty_cache()
    for extra in BENCH_RUNS:
        if f"{UHD_W}x{UHD_H}" in extra and not uhd_ok:
            failures.append(f"bench {' '.join(extra)}: not run, the "
                            f"{UHD_W}x{UHD_H} check failed")
            continue
        rec = bench_child(extra, failures)
        if not extra and rec:
            floor = HEADLINE_FLOOR * MAIN_BATCH * 1e3 / main_ms
            print(f"bench headline {rec['value']} frames/s "
                  f"({MAIN_BATCH * 1e3 / rec['value']:.3f} ms a batch on the "
                  f"host's clock, {rec['device_ms_per_batch']} on the card's) "
                  f"against {HEADLINE_FLOOR} x {MAIN_BATCH} / {main_ms:.3f} "
                  f"ms = {floor:.1f} frames/s ({card})", flush=True)
            if rec["value"] < floor:
                failures.append(f"bench (headline): {rec['value']} frames/s "
                                f"below {floor:.1f}")


def phase_profiles(frames: torch.Tensor, per_kernel: dict, card: str,
                   failures) -> dict:
    """(j) the in-context profiler at 1920x1080 through its entry point,
    each of INCONTEXT_RUNS: every run's launches per call must be those of
    the classes it searched (1 / 7 / 9 for the whole search, one for a
    class alone, one fewer for a class left out), each sweep with 17
    classes alone and 17 left out.  The batch-16 sweep is printed beside
    each class's kernel time on the main path (``per_kernel``).  Then the
    host's CPU filtering sweep (every band bit-equal to the whole frame)
    beside the card's filter ms per frame on the main path's batch, for
    the sweep's variants.  Returns {batch: ms/frame}."""
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans
    from vvc_mip_gpu_tpu_torch.tools import (
        profile_cpu_filtering, profile_incontext)

    size_id = {f"{cp.shape.width}x{cp.shape.height}": cp.shape.size_id
               for cp in class_plans(MAIN_W, MAIN_H)}
    whole = [1, 7, 9]
    records, per_frame, sweep = [], {}, {}
    for argv in INCONTEXT_RUNS:
        print(f"profile_incontext {' '.join(argv)}:", flush=True)
        try:
            recs = profile_incontext.main(argv)
        except RuntimeError as err:
            failures.append(f"profile_incontext {argv}: {err}")
            continue
        records += recs
        if argv[0] == "--batch" and len(argv) == 2:  # the batch sweep
            per_frame[int(argv[1])] = recs[0]["ms_per_frame"]
        if "--loo" in argv and recs[0]["frames"] == MAIN_BATCH:
            sweep = {(rec["what"], rec["class"]): rec for rec in recs}
    bad = []
    for rec in records:
        if rec["what"] == "sum":
            continue
        own = ([int(size_id[rec["class"]] == k) for k in range(3)]
               if rec["class"] else [0, 0, 0])
        want = {"e2e": whole, "alone": own,
                "without": [w - o for w, o in zip(whole, own)]}[rec["what"]]
        if rec["launches"] != want or not rec["ms"] > 0:
            bad.append(f"{rec['what']} {rec['class']}: launches "
                       f"{rec['launches']}, want {want}, {rec['ms']} ms")
    n_loo = sum("--loo" in argv for argv in INCONTEXT_RUNS)
    n_class = sum("--class" in argv for argv in INCONTEXT_RUNS)
    want = (17 * n_loo + n_class, 17 * n_loo,
            len(INCONTEXT_RUNS) - n_class, n_loo)
    kinds = [rec["what"] for rec in records]
    got = tuple(kinds.count(k) for k in ("alone", "without", "e2e", "sum"))
    if got != want:
        bad.append(f"records alone/without/e2e/sum {got}, want {want}")
    if bad:
        failures.append(f"profile_incontext: {bad}")
    kernel_ms = {name: ms for agg in per_kernel.values()
                 for name, ms in agg["classes"].items()}
    for name, ms in kernel_ms.items():
        alone, left = sweep.get(("alone", name)), sweep.get(("without", name))
        if alone and left:
            print(f"in context, batch {MAIN_BATCH}, {name}: alone "
                  f"{alone['ms']:.4f} ms, its kernel {ms:.4f} ms, left-out "
                  f"delta {left['delta_ms']:+.4f} ms ({card})")
    print(f"profile_incontext: {len(records)} records, launches per call "
          f"{'as searched' if not bad else f'WRONG in {len(bad)}'}; ms per "
          f"frame by batch: "
          + ", ".join(f"{b}: {ms:.4f}" for b, ms in per_frame.items())
          + f" ({card})", flush=True)

    ncpu = profile_cpu_filtering.host_cpus()
    try:
        table = profile_cpu_filtering.main(["--max-workers", str(ncpu)])
    except RuntimeError as err:
        failures.append(f"profile_cpu_filtering: {err}")
        return per_frame
    for ftype, by_workers in table.items():
        batch_ms = Timer(lambda: filter_frames(frames, ftype, 0), 5).ms
        one_ms = Timer(lambda: filter_frames(frames[:1], ftype, 0), 10).ms
        best = min(by_workers, key=by_workers.get)
        print(f"filter {ftype}[0] {MAIN_W}x{MAIN_H}: card "
              f"{batch_ms / frames.shape[0]:.4f} ms/frame in a batch of "
              f"{frames.shape[0]}, {one_ms:.4f} ms one frame; host CPU "
              f"{by_workers[1]:.1f} ms with 1 worker, {by_workers[best]:.1f} "
              f"ms with {best} of {ncpu} CPUs ({card})", flush=True)
    return per_frame


def golden_futures(pool, frame: np.ndarray, ref: np.ndarray, done: list):
    """The golden model's 47 groups of one frame submitted to ``pool``,
    the largest (CUs x modes x samples a CTU) first; {group: future}.
    Each future appends its completion time to ``done``."""
    from vvc_mip_gpu_tpu_torch.constants import GROUPS
    from vvc_mip_gpu_tpu_torch.golden import reference_model as gm

    futures = {}
    for g in sorted(GROUPS, key=lambda g: -g.cus_per_ctu * g.total_modes
                    * g.width * g.height):
        futures[g.index] = pool.submit(gm.group_costs, frame, ref, g.index)
        futures[g.index].add_done_callback(
            lambda _: done.append(time.perf_counter()))
    return futures


def strided_index(j: int) -> tuple[int, int, int]:
    """(group, CU, mode) of index ``j`` of a CTU's strided cost slab."""
    from vvc_mip_gpu_tpu_torch.constants import (
        GROUPS, STRIDED_DISTORTIONS_PER_CTU)

    g = int(np.searchsorted(STRIDED_DISTORTIONS_PER_CTU, j, "right")) - 1
    cu, mode = divmod(j - int(STRIDED_DISTORTIONS_PER_CTU[g]),
                      GROUPS[g].total_modes)
    return g, cu, mode


def golden_differences(label: str, golden: dict, fields: dict,
                       valid: torch.Tensor) -> list[str]:
    """The card's ``fields`` ({name: [nCTU, 97840] tensor}) of one frame
    against the golden model's costs, in int64, on valid CUs only, and
    the card's validity mask against the golden model's per-group masks.
    Prints the count of entries compared and the first mismatching (CTU,
    group, CU, mode); returns what differs."""
    from vvc_mip_gpu_tpu_torch.constants import GROUPS
    from vvc_mip_gpu_tpu_torch.golden import reference_model as gm

    mask = valid.cpu().numpy()
    bad = []
    if not np.array_equal(mask, np.concatenate(
            [np.repeat(golden[g.index].valid, g.total_modes, axis=1)
             for g in GROUPS], axis=1)):
        bad.append("validity mask")
    for name, t in fields.items():
        got = t.cpu().numpy().astype(np.int64)
        want = gm.flatten_strided(golden, name)
        mism = np.argwhere((got != want) & mask)
        if len(mism):
            ctu, j = (int(v) for v in mism[0])
            g, cu, mode = strided_index(j)
            bad.append(f"{name}: {len(mism)} valid entries, first at CTU "
                       f"{ctu} group {g} ({GROUPS[g].name}) CU {cu} mode "
                       f"{mode}: card {got[ctu, j]}, golden {want[ctu, j]}")
    print(f"check golden {label}: {', '.join(fields)}, {int(mask.sum())} "
          f"valid entries each vs the golden model, validity mask: "
          f"{'bit-exact, mask equal' if not bad else bad}", flush=True)
    return bad


def spot_cus(width: int, height: int, seed: int) -> list[tuple]:
    """Valid CUs for the scalar oracle: per group, one from each of the
    top-left CTU, the top CTU row, the left and the last CTU column, the
    bottom CTU row (partial where the height is not a multiple of 128:
    only CUs whose full height lies inside the frame) and an interior
    CTU, each with a random normal and a random transposed mode.  Returns
    [(where, CTU, group, CU, x, y, mode)]."""
    from vvc_mip_gpu_tpu_torch.constants import GROUPS, num_ctus
    from vvc_mip_gpu_tpu_torch.golden import reference_model as gm

    cols, rows, n_ctu = num_ctus(width, height)
    rng = np.random.default_rng(seed)
    out = []
    for g in GROUPS:
        xs, ys = gm.global_positions(g.index, width, height)
        valid = (xs + g.width <= width) & (ys + g.height <= height)
        where = {
            "top-left": 0, "top row": int(rng.integers(1, cols)),
            "left column": int(rng.integers(1, rows - 1)) * cols,
            "last column": int(rng.integers(1, rows - 1)) * cols + cols - 1,
            "bottom row": n_ctu - cols + int(rng.integers(cols)),
            "interior": int(rng.integers(1, rows - 1)) * cols
            + int(rng.integers(1, cols - 1))}
        for name, ctu in where.items():
            cus = np.flatnonzero(valid[ctu])
            if not len(cus):  # e.g. no 64x64 CU fits 56 rows
                continue
            cu = int(rng.choice(cus))
            for mode in (int(rng.integers(g.num_modes)),
                         g.num_modes + int(rng.integers(g.num_modes))):
                out.append((name, ctu, g.index, cu, int(xs[ctu, cu]),
                            int(ys[ctu, cu]), mode))
    return out


def scalar_differences(frame: np.ndarray, spots: list, got: list) -> list:
    """The scalar oracle's (SAD, SATD, minSadHad) of each spot of
    ``spot_cus`` on ``frame`` (original samples) against ``got``, a
    (sad, satd, msh) triple per spot; the differing spots."""
    from vvc_mip_gpu_tpu_torch.constants import GROUPS
    from vvc_mip_gpu_tpu_torch.golden import scalar_oracle as so

    bad = []
    for spot, triple in zip(spots, got):
        _, ctu, group, cu, x, y, mode = spot
        g = GROUPS[group]
        want = so.cu_cost(frame, frame, x, y, g.width, g.height, g.size_id,
                          mode)
        if tuple(int(v) for v in triple) != want:
            bad.append(f"CTU {ctu} group {group} ({g.name}) CU {cu} at "
                       f"({x}, {y}) mode {mode}: {tuple(triple)} vs the "
                       f"oracle's {want}")
    return bad


def spot_values(costs, b: int, spots: list) -> list:
    """(SAD, SATD, minSadHad) of frame ``b`` of a full-report FrameCosts
    at each spot of ``spot_cus``, gathered on the card."""
    from vvc_mip_gpu_tpu_torch.constants import (
        GROUPS, STRIDED_DISTORTIONS_PER_CTU)

    ctu = torch.tensor([s[1] for s in spots], device=costs.sad.device)
    j = torch.tensor([int(STRIDED_DISTORTIONS_PER_CTU[s[2]])
                      + s[3] * GROUPS[s[2]].total_modes + s[6]
                      for s in spots], device=costs.sad.device)
    fields = [t[b, ctu, j].cpu().tolist()
              for t in (costs.sad, costs.satd, costs.min_sad_had)]
    return list(zip(*fields))


def reference_card(width: int, height: int, frames: np.ndarray,
                   smooth: np.ndarray, dev: torch.device,
                   filtered: np.ndarray | None = None, filters=REF_FILTERS,
                   phase: str = "l") -> tuple:
    """(l.1)-(l.4) on the card at one frame size (``phase`` "m": (m.1)-
    (m.4) at 3840x2160): the 32 filter pairs against the golden filters
    on frame 0 and the smooth frame; the main path,
    MipCostEngine(max_performance=True).compute_batch over the 16 distinct
    ``frames``, frames 0-1 whole against the plain path; the full report
    of frame 0; the filtered full report of ``filtered`` (default
    ``smooth``) for each of ``filters``, compute_batch(frame,
    filter_frames(frame, ...)), whole against the plain path.  Each
    path's launches held to 1 / 7 / 9, and each filtered path's filter
    kernel launches to 1.  Returns ({path: FrameCosts} for the golden
    model's comparison, what failed, {filter pair: its filtered path's
    filter kernel launches})."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        FrameCosts, MipCostEngine)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames

    size = f"{width}x{height}"
    t0 = time.perf_counter()
    bad = [f"({phase}.1) {d}" for d in filters_differ(
        np.stack([frames[0], smooth]), dev, False)]
    print(f"check ({phase}.1) {size} filters: {len(filter_pairs())} "
          f"variant/KernelIdx pairs x 2 frames (noise, smooth), card vs "
          f"the NumPy golden filters: {'bit-exact' if not bad else bad} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    card = torch.from_numpy(frames).to(dev)
    main, launches = count_launches(lambda: MipCostEngine(
        width, height, max_performance=True).compute_batch(card))
    f16 = card[:2].to(torch.int16).contiguous()
    same = torch.equal(main.min_sad_had[:2],
                       plain_costs(f16, f16, width, height, 1)[0])
    print(f"check ({phase}.2) {size} main path, {len(frames)} frames: "
          f"launches {launches}; minSadHad of frames 0-1 vs the plain path: "
          f"{'bit-exact' if same else 'DIFFERS'}", flush=True)
    if not same:
        bad.append(f"({phase}.2) {size} main path differs from the plain "
                   f"path")
    del card, f16
    costs, counts = {"main": main}, {"main": launches}
    full_card = torch.from_numpy(frames[:1]).to(dev)
    costs["full"], counts["full"] = count_launches(
        lambda: MipCostEngine(width, height).compute_batch(full_card))
    filtered_card = torch.from_numpy((smooth if filtered is None else
                                      filtered).astype(np.int32))[None].to(
        dev)
    refs, filter_counts = {}, {}
    for pair in filters:
        def filtered_path(pair=pair):
            refs[pair] = filter_frames(filtered_card, *pair)
            return MipCostEngine(width, height).compute_batch(
                filtered_card, refs[pair])
        costs[pair], counts[pair] = count_launches(filtered_path)
        filter_counts[pair] = filter_frames.launches
    bad += [f"{size} {name} launches {n}, want [1, 7, 9]"
            for name, n in counts.items() if n != [1, 7, 9]]
    bad += [f"({phase}.4) {size} {pair[0]}[{pair[1]}] {filter_frames.name} "
            f"launches {n}, want 1"
            for pair, n in filter_counts.items() if n != 1]
    print(f"({phase}) {size} launches: " + ", ".join(
        f"{name} {n}" for name, n in counts.items()) + "; "
        f"{filter_frames.name} " + ", ".join(
        f"{pair[0]}[{pair[1]}] {n}" for pair, n in filter_counts.items()),
        flush=True)
    for pair in filters:
        ref = refs[pair]
        sad, satd = plain_costs(filtered_card.to(torch.int16).contiguous(),
                                ref.to(torch.int16).contiguous(), width,
                                height, 2)
        want = FrameCosts(sad, satd, torch.minimum(2 * sad, satd), None)
        diff = differing(costs[pair], want, ("sad", "satd", "min_sad_had"))
        del sad, satd, want
        print(f"check ({phase}.4) {size} {pair[0]}[{pair[1]}] filtered on "
              f"the card, full report: whole tensors (out-of-frame CUs "
              f"included) vs the plain path: "
              f"{'bit-exact' if not diff else diff}", flush=True)
        bad += [f"({phase}.4) {size} {pair[0]}[{pair[1]}] vs the plain "
                f"path: {d}" for d in diff]
    return costs, bad, filter_counts


def cli_against_card(width: int, height: int, target_ctu: int, chunks: int,
                     tmp: str, card: str, label: str,
                     keep: bool = True) -> tuple[str, float, list[str]]:
    """The port's CLI in-process at ``width`` x ``height``: filtered
    (FILTER), full report, 2 synthetic frames in ``chunks`` chunks (1: the
    default --BatchFrames; 2: one frame a chunk, through both slots of the
    readback ring and the writer thread), --TargetCTU ``target_ctu``.  Its
    decisions and target-CTU CSVs against the C writer's export of the
    card's costs of the same frames, byte for byte, and its launches one
    per class a chunk.  Without ``keep`` each decisions CSV is deleted
    once compared (the target-CTU CSV stays).  Returns (the output prefix,
    wall seconds, what failed)."""
    from vvc_mip_gpu_tpu_torch.io.export import (
        export_decisions_csv, export_target_ctu_csv)
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames

    size = f"{width}x{height}"
    prefix = str(Path(tmp) / f"cli{size}_")
    args = ["-f", "2", "-s", size, "--Synthetic", "--FullDistortion",
            "--FilterType", FILTER[0], "--KernelIdx", str(FILTER[1]),
            "--TargetCTU", str(target_ctu),
            *([] if chunks == 1 else ["--BatchFrames", "1"])]
    (rc, wall, _), launches = count_launches(lambda: cli_in_process(
        args + ["-l", prefix], Path(tmp) / f"cli{size}_stdout.txt"))
    frames = torch.from_numpy(synthetic_frames(
        2, width, height).astype(np.int32)).cuda()
    costs = MipCostEngine(width, height).compute_batch(
        frames, filter_frames(frames, *FILTER))
    sad, satd, msh = (t.cpu().numpy() for t in (
        costs.sad, costs.satd, costs.min_sad_had))
    del frames, costs
    again = Path(tmp) / f"cli{size}_again.csv"
    differ, mb = [], []
    for poc in (0, 1):
        export_decisions_csv(again, msh[poc], width, sad=sad[poc],
                             satd=satd[poc], poc=poc)
        path = Path(f"{prefix}mip_decisions_poc{poc}.csv")
        mb.append(path.stat().st_size / 1e6)
        if not filecmp.cmp(again, path, shallow=False):
            differ.append(path.name)
        again.unlink()
        if not keep:
            path.unlink()
    export_target_ctu_csv(
        again, list(msh[:, target_ctu]), width, target_ctu,
        sad_per_frame=list(sad[:, target_ctu]),
        satd_per_frame=list(satd[:, target_ctu]), pocs=[0, 1])
    name = f"target_ctu{target_ctu}.csv"
    if not filecmp.cmp(again, prefix + name, shallow=False):
        differ.append(name)
    again.unlink()
    want = [chunks, 7 * chunks, 9 * chunks]
    bad = []
    if rc or launches != want or differ:
        bad.append(f"{label} CLI {size}: rc {rc}, launches {launches} (want "
                   f"{want}), files differing from the export of the card's "
                   f"costs {differ}")
    print(f"check {label} CLI {' '.join(args)}: rc {rc}, {wall:.2f} s wall, "
          f"launches {launches}; decisions CSVs ({mb[0]:.1f} and "
          f"{mb[1]:.1f} MB) and the target CSV equal the export of the "
          f"card's costs byte for byte: {not differ} ({card})", flush=True)
    return prefix, wall, bad


def reference_cli(tmp: str, card: str) -> tuple[dict, list[str]]:
    """(l.5) cli_against_card at each of REF_SIZES, target CTU
    REF_TARGET_CTU: one chunk at the smallest size, whose files stay for
    the golden comparison, one frame a chunk at the others.  Returns
    ({size: (prefix, wall s)}, what failed)."""
    out, bad = {}, []
    for width, height in REF_SIZES:
        smallest = (width, height) == REF_SIZES[0]
        prefix, wall, more = cli_against_card(
            width, height, REF_TARGET_CTU, 1 if smallest else 2, tmp, card,
            "(l.5)", keep=smallest)
        out[f"{width}x{height}"] = (prefix, wall)
        bad += more
    return out, bad


def golden_csv_diff(prefix: str, golden: list, tmp: str) -> list[str]:
    """(l.5) the smallest size's CLI decisions CSVs against CSVs of the
    golden model's costs (``golden``: one {group: GroupCosts} a frame)
    written by the port's C writer, through the port's decisions diff on
    the in-frame rows; the diff's in-frame rows must be the engine's
    validity mask.  Returns what failed."""
    from vvc_mip_gpu_tpu_torch.golden import reference_model as gm
    from vvc_mip_gpu_tpu_torch.io.export import export_decisions_csv
    from vvc_mip_gpu_tpu_torch.models.cost_engine import _validity_mask
    from vvc_mip_gpu_tpu_torch.tools import diff_decisions

    width, height = REF_SIZES[0]
    bad = []
    for poc, costs in enumerate(golden):
        path = Path(tmp) / f"golden_poc{poc}.csv"
        export_decisions_csv(
            path, gm.flatten_strided(costs, "min_sad_had"), width,
            sad=gm.flatten_strided(costs, "sad"),
            satd=gm.flatten_strided(costs, "satd"), poc=poc)
        cli_csv = f"{prefix}mip_decisions_poc{poc}.csv"
        table = diff_decisions.read(cli_csv)
        in_frame = ((table["X"] + table["W"] <= width)
                    & (table["Y"] + table["H"] <= height))
        mask_ok = np.array_equal(in_frame,
                                 _validity_mask(width, height).ravel())
        print(f"diff_decisions {cli_csv} (the CLI's) vs {path.name} (the "
              f"golden model's) --ignore-invalid {width}x{height}:",
              flush=True)
        rc = diff_decisions.main([cli_csv, str(path), "--ignore-invalid",
                                  f"{width}x{height}"])
        print(f"check (l.5) golden CSV, POC {poc}: diff rc {rc}; in-frame "
              f"rows {int(in_frame.sum())} of {len(in_frame)}, the engine's "
              f"validity mask: {mask_ok}", flush=True)
        if rc or not mask_ok:
            bad.append(f"(l.5) golden CSV POC {poc}: diff rc {rc}, mask "
                       f"{mask_ok}")
    return bad


def size_timings(w: int, h: int, b: int, dev: torch.device,
                 int_rate: float, card: str, bad: list, phase: str) -> dict:
    """The main path at ``w`` x ``h``, batch ``b`` of uniform-random frames,
    with the host quiet: back to back (CUDA events), the card's busy time
    in it and its 17 cost kernels by name (torch.profiler), and each class
    alone beside its bound (class_times); printed under ``phase``.
    Returns {"e2e_ms", "busy_ms", "cost_kernels_ms", "kernels_ms",
    "bound_ms"}."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine

    frames = torch.from_numpy(np.random.default_rng(60).integers(
        0, 1024, (b, h, w), dtype=np.int32)).to(dev)
    engine = MipCostEngine(w, h, max_performance=True)
    e2e = Timer(lambda: engine.compute_batch(frames), TIMED_ITERS, 2).ms
    on_card = device_times(lambda: engine.compute_batch(frames), TIMED_ITERS)
    in_batch = {f"{m[1]}x{m[2]}": ms for name, ms in on_card.items()
                if (m := COST_KERNEL.search(name))}
    if len(in_batch) != 17:
        bad.append(f"{w}x{h} batch {b}: the profiler saw {len(in_batch)} "
                   f"cost kernels, want 17: {sorted(on_card)}")
    busy = sum(on_card.values())
    per_kernel = class_times(frames.to(torch.int16).contiguous(), w, h,
                             int_rate, bad, f" at {w}x{h} batch {b}")
    alone = {c: ms for agg in per_kernel.values()
             for c, ms in agg["classes"].items()}
    bounds = {c: ms for agg in per_kernel.values()
              for c, ms in agg["class_bounds"].items()}
    t = {"e2e_ms": e2e, "busy_ms": busy,
         "cost_kernels_ms": sum(in_batch.values()),
         "kernels_ms": sum(alone.values()), "bound_ms": sum(bounds.values())}
    print(f"({phase}) {w}x{h} batch {b}, each class in the batch (profiler) "
          f"/ alone (CUDA events) / bound, ms: " + ", ".join(
              f"{c} {in_batch.get(c, float('nan')):.4f} / {alone[c]:.4f} "
              f"/ {bounds[c]:.4f}" for c in alone), flush=True)
    print(f"({phase}) {w}x{h} main path: {e2e:.4f} ms per batch of {b} "
          f"({b * 1e3 / e2e:.1f} frames/s); on the card (torch.profiler) "
          f"{busy:.4f} ms busy, the 17 cost kernels "
          f"{t['cost_kernels_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms); "
          f"host share {e2e - busy:.4f} ms ({(e2e - busy) / e2e:.1%} of "
          f"the batch idle); the 17 kernels one by one "
          f"{t['kernels_ms']:.4f} ms ({card})", flush=True)
    return t


def bench_against_kernels(extra: list[str], times: dict, card: str,
                          bad: list) -> None:
    """bench_child with the flags ``extra`` (``--resolution WxH`` first);
    when it times the compute window of the main path (no --filtered,
    --window, --with-export or --latency), its ms a batch on the host's
    clock beside the 17 cost kernels' device ms of that size and batch in
    ``times`` ({(w, h, b): size_timings})."""
    rec = bench_child(extra, bad)
    other_window = {"--filtered", "--window", "--with-export", "--latency"}
    if rec and not other_window & set(extra):
        w, h = (int(v) for v in extra[1].split("x"))
        b = (int(extra[extra.index("--batch") + 1]) if "--batch" in extra
             else MAIN_BATCH)
        host_ms = b * 1e3 / rec["value"]
        kernels = times[w, h, b]["cost_kernels_ms"]
        print(f"bench {' '.join(extra)}: {host_ms:.4f} ms a batch of {b} "
              f"on the host's clock, {rec['device_ms_per_batch']} on the "
              f"card's; minus the 17 cost kernels in the batch "
              f"({kernels:.4f} ms): {host_ms - kernels:.4f} ms ({card})",
              flush=True)


def phase_reference(tmp: str, dev: torch.device, card: str,
                    int_rate: float, failures) -> dict:
    """(l) the reference's other three frame sizes, REF_SIZES, on the
    card.  The golden model (golden/reference_model.py) on a spawned pool
    while the card runs reference_card and reference_cli: frame 0 of each
    size's batch, its smooth frame under each of REF_FILTERS (fed by
    golden/filters_golden.py) and the CLI's two filtered frames at the
    smallest size; each against the card on valid CUs, masks equal, and
    the CLI's CSVs against the golden model's through the port's
    decisions diff (golden_csv_diff).  Then, with the pool gone, each
    size's main path timed beside its 17 kernels and their bounds (also
    at batch REF_LARGE_BATCH at the smallest), and the port's bench in
    REF_BENCH_RUNS.  Returns the timings."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.golden.filters_golden import filter_frame
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.tools.profile_cpu_filtering import host_cpus

    t_phase = time.perf_counter()
    inputs = {(w, h): (
        np.random.default_rng(40 + i).integers(
            0, 1024, (MAIN_BATCH, h, w), dtype=np.int32),
        synthetic_frames(1, w, h, seed=50 + i)[0].astype(np.int64))
        for i, (w, h) in enumerate(REF_SIZES)}
    cli_frames = synthetic_frames(2, *REF_SIZES[0]).astype(np.int64)
    bad, done = [], []
    workers = host_cpus()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        t_pool = time.perf_counter()
        pending = {}
        for (w, h), (frames, smooth) in inputs.items():
            noise = frames[0].astype(np.int64)
            pending[w, h, "noise"] = golden_futures(pool, noise, noise, done)
            for pair in REF_FILTERS:
                pending[w, h, pair] = golden_futures(
                    pool, smooth, filter_frame(smooth, *pair), done)
        for poc, frame in enumerate(cli_frames):
            pending["cli", poc] = golden_futures(
                pool, frame, filter_frame(frame, *FILTER), done)
        # the card meanwhile
        card_costs = {}
        for (w, h), (frames, smooth) in inputs.items():
            card_costs[w, h], more, _ = reference_card(w, h, frames,
                                                       smooth, dev)
            bad += more
        cli, more = reference_cli(tmp, card)
        bad += more
        golden = {key: {g: f.result() for g, f in futures.items()}
                  for key, futures in pending.items()}
    golden_s = max(done) - t_pool
    for (w, h), costs in card_costs.items():
        full = ("sad", "satd", "min_sad_had")
        bad += golden_differences(
            f"(l.2) {w}x{h} the main path's minSadHad, frame 0",
            golden[w, h, "noise"],
            {"min_sad_had": costs["main"].min_sad_had[0]},
            costs["main"].valid[0])
        bad += golden_differences(
            f"(l.3) {w}x{h} full report, frame 0", golden[w, h, "noise"],
            {f: getattr(costs["full"], f)[0] for f in full},
            costs["full"].valid[0])
        for pair in REF_FILTERS:
            bad += golden_differences(
                f"(l.4) {w}x{h} smooth frame, {pair[0]}[{pair[1]}] on the "
                f"card vs golden/filters_golden.py for the golden model, "
                f"full report", golden[w, h, pair],
                {f: getattr(costs[pair], f)[0] for f in full},
                costs[pair].valid[0])
    del card_costs
    small = "{}x{}".format(*REF_SIZES[0])
    bad += golden_csv_diff(cli[small][0], [golden["cli", 0],
                                           golden["cli", 1]], tmp)
    del golden
    n_ctu = (sum(num_ctus(w, h)[2] for w, h in REF_SIZES)
             * (1 + len(REF_FILTERS)) + 2 * num_ctus(*REF_SIZES[0])[2])
    print(f"golden model (l): {len(pending)} frames, {n_ctu} CTUs, in "
          f"{golden_s:.1f} s wall on {workers} spawned workers ({card})",
          flush=True)

    # timings, the host quiet: the main path back to back (CUDA events),
    # the card's busy time in it (torch.profiler) and its 17 kernels one by
    # one; 1920x1080 beside them
    times = {}
    sizes = [(w, h, MAIN_BATCH) for w, h in REF_SIZES]
    sizes += [(*REF_SIZES[0], REF_LARGE_BATCH), (MAIN_W, MAIN_H, MAIN_BATCH)]
    for w, h, b in sizes:
        times[w, h, b] = size_timings(w, h, b, dev, int_rate, card, bad,
                                      "l")
    torch.cuda.empty_cache()
    for extra in REF_BENCH_RUNS:
        bench_against_kernels(extra, times, card, bad)
    if bad:
        failures.append(f"reference sizes (l): {bad}")
    wall = time.perf_counter() - t_phase
    print(f"phase (l): {wall:.1f} s ({card})", flush=True)
    return {"times": times, "golden_s": golden_s, "phase_s": wall}


def cli_latency_against_engine(width: int, height: int, tmp: str,
                               card: str, label: str) -> list[str]:
    """The CLI's --LatencyMode on one synthetic frame, max-performance
    (the latency engine over every visible card, read back through the
    pinned ring): its decisions CSV against the C writer's export of
    MipCostEngine's costs of that frame, byte for byte, then deleted; one
    launch per class.  Returns what failed."""
    from vvc_mip_gpu_tpu_torch.io.export import export_decisions_csv
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine

    size = f"{width}x{height}"
    prefix = str(Path(tmp) / f"lat{size}_")
    args = ["-f", "1", "-s", size, "--Synthetic", "--LatencyMode"]
    (rc, wall, _), launches = count_launches(lambda: cli_in_process(
        args + ["-l", prefix], Path(tmp) / f"lat{size}_stdout.txt"))
    frame = synthetic_frames(1, width, height)[0].astype(np.int32)
    msh = MipCostEngine(width, height, max_performance=True)(
        frame).min_sad_had.cpu().numpy()
    again = Path(tmp) / f"lat{size}_again.csv"
    export_decisions_csv(again, msh, width)
    got = Path(prefix + "mip_decisions.csv")
    same = filecmp.cmp(again, got, shallow=False)
    mb = got.stat().st_size / 1e6
    again.unlink()
    got.unlink()
    print(f"check {label} CLI {' '.join(args)}: rc {rc}, {wall:.2f} s wall, "
          f"launches {launches}; its decisions CSV ({mb:.1f} MB) equals the "
          f"export of MipCostEngine's costs byte for byte: {same} ({card})",
          flush=True)
    if rc or not same or launches != [1, 7, 9]:
        return [f"{label} CLI --LatencyMode {size}: rc {rc}, launches "
                f"{launches}, CSV equal to the export of MipCostEngine's "
                f"costs: {same}"]
    return []


def target_golden_differences(path: str, golden: dict, width: int, ctu: int,
                              poc: int, tmp: str) -> list[str]:
    """The POC ``poc`` rows of a target-CTU CSV (the CLI's, at ``path``)
    against the C writer's export of the golden model's costs of CTU
    ``ctu`` (``golden``: {group: GroupCosts} of that frame): byte for byte
    on the rows of in-frame CUs; on the rows of out-of-frame CUs, whose
    costs differ by design (the golden model clips their coordinates, the
    port replicates edges), the identity columns.  Returns what
    differs."""
    from vvc_mip_gpu_tpu_torch.constants import GROUPS
    from vvc_mip_gpu_tpu_torch.golden import reference_model as gm
    from vvc_mip_gpu_tpu_torch.io.export import export_target_ctu_csv

    one = {g: gm.GroupCosts(*(a[ctu:ctu + 1] for a in (
        c.sad, c.satd, c.min_sad_had, c.valid))) for g, c in golden.items()}
    want_path = Path(tmp) / f"golden_target_ctu{ctu}_poc{poc}.csv"
    export_target_ctu_csv(
        want_path, [gm.flatten_strided(one, "min_sad_had")[0]], width, ctu,
        sad_per_frame=[gm.flatten_strided(one, "sad")[0]],
        satd_per_frame=[gm.flatten_strided(one, "satd")[0]], pocs=[poc])
    want = want_path.read_bytes().splitlines()
    want_path.unlink()
    lines = Path(path).read_bytes().splitlines()
    got = [line for line in lines[1:] if line.startswith(b"%d," % poc)]
    valid = np.concatenate([np.repeat(one[g.index].valid[0], g.total_modes)
                            for g in GROUPS])
    bad = [] if lines[0] == want[0] else [f"header {lines[0]!r}"]
    if len(got) != len(valid) or len(want) != len(valid) + 1:
        return bad + [f"{len(got)} POC {poc} rows, want {len(valid)}"]
    rows = want[1:]
    in_frame = [i for i in np.flatnonzero(valid) if got[i] != rows[i]]
    identity = [i for i in np.flatnonzero(~valid)
                if got[i].rsplit(b",", 3)[0] != rows[i].rsplit(b",", 3)[0]]
    if in_frame:
        bad.append(f"{len(in_frame)} in-frame rows, first {got[in_frame[0]]!r}"
                   f" vs the golden model's {rows[in_frame[0]]!r}")
    if identity:
        bad.append(f"{len(identity)} out-of-frame rows' identity columns")
    print(f"check target CTU {ctu} CSV, POC {poc}, vs the export of the "
          f"golden model's costs: {int(valid.sum())} in-frame rows byte for "
          f"byte, {int((~valid).sum())} out-of-frame rows by their identity "
          f"columns: {'equal' if not bad else bad}", flush=True)
    return bad


def phase_uhd_entry_points(tmp: str, dev: torch.device, card: str,
                           int_rate: float, failures) -> dict:
    """(m) 3840x2160 through every entry point of the port.  The golden
    model on a spawned pool, for two frames: uhd_frames()'s noise frame on
    its original samples and the CLI's POC 0 under FILTER (fed by
    golden/filters_golden.py).  The card meanwhile: (m.1)-(m.4)
    reference_card over 16 frames whose frame 0 is the noise frame, the
    filtered report on the CLI's POC 0; (m.5) cli_against_card with the
    bottom-right CTU as target, each decisions CSV deleted once compared
    (too little free space in ``tmp`` is a failure); (m.6) the CLI's
    --LatencyMode on one frame; (m.7) sharded_checks on the (2, 2) and
    (1, 2) meshes over UHD_MESH_FRAMES frames and latency_checks with 1
    and 4 parts, the one-part ring path against the golden model; (m.8)
    inspect_cases at the bottom-right, bottom-left and an interior CTU.  Then the golden comparisons (valid CUs, masks equal)
    and the target CTU's POC-0 rows against the golden model's export;
    then, the pool gone, (m.9) size_timings at batch 16 and the bench in
    UHD_BENCH_RUNS.  Returns the timings."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.golden.filters_golden import filter_frame
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.tools.profile_cpu_filtering import host_cpus

    t_phase = time.perf_counter()
    size = f"{UHD_W}x{UHD_H}"
    cols, rows, n_ctu = num_ctus(UHD_W, UHD_H)
    target = n_ctu - 1  # bottom-right, in the partial bottom CTU row
    noise, smooth = uhd_frames()
    frames = np.concatenate([noise[None], np.random.default_rng(70).integers(
        0, 1024, (MAIN_BATCH - 1, UHD_H, UHD_W), dtype=np.int32)])
    cli0 = synthetic_frames(2, UHD_W, UHD_H)[0].astype(np.int64)
    free = shutil.disk_usage(tmp).free
    need = 3 * n_ctu * PER_CTU * CSV_ROW_BYTES  # two CLI CSVs and an export
    print(f"(m) {size}: {n_ctu} CTUs, {rows} rows (the last of "
          f"{UHD_H - (rows - 1) * 128} samples); the temporary directory has "
          f"{free / 1e9:.1f} GB free, the CLI's CSVs need up to "
          f"{need / 1e9:.1f} GB at once", flush=True)
    bad, done = [], []
    workers = host_cpus()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        t_pool = time.perf_counter()
        noise64 = noise.astype(np.int64)
        pending = {"noise": golden_futures(pool, noise64, noise64, done),
                   "cli": golden_futures(pool, cli0,
                                         filter_frame(cli0, *FILTER), done)}
        # the card meanwhile
        costs, more, filter_counts = reference_card(
            UHD_W, UHD_H, frames, smooth, dev, filtered=cli0,
            filters=(FILTER,), phase="m")
        bad += more
        prefix = None
        if free < need:
            bad.append(f"(m.5) the temporary directory has {free / 1e9:.1f} "
                       f"GB free, the CLI's CSVs need {need / 1e9:.1f} GB")
        else:
            prefix, _, more = cli_against_card(UHD_W, UHD_H, target, 1, tmp,
                                               card, "(m.5)", keep=False)
            bad += more
            bad += cli_latency_against_engine(UHD_W, UHD_H, tmp, card,
                                              "(m.6)")
        mesh_frames = torch.from_numpy(frames[:UHD_MESH_FRAMES]).to(dev)
        sharded_checks(mesh_frames,
                       costs["main"].min_sad_had[:UHD_MESH_FRAMES], UHD_W,
                       UHD_H, ((2, 2, True), (1, 2, False)), bad)
        del mesh_frames
        latency_checks(noise, UHD_W, UHD_H, dev, (1, 4), bad)
        filtered = filter_frames(torch.from_numpy(cli0.astype(np.int32))[
            None].to(dev), *FILTER)[0]
        interior = (rows // 2) * cols + cols // 2
        corner = n_ctu - cols  # bottom-left
        # groups of every SizeId (2, 1, 0) at each CTU
        inspect_cases(
            [(noise, None, 0, target), (noise, None, 32, target),
             (noise, None, 46, target), (cli0, filtered, 8, corner),
             (cli0, filtered, 35, corner), (cli0, filtered, 46, corner),
             (smooth, None, 20, interior), (smooth, None, 41, interior),
             (smooth, None, 46, interior)], f" {size}", bad)
        golden = {name: {g: f.result() for g, f in futures.items()}
                  for name, futures in pending.items()}
    # after the pool's shutdown: every completion callback has run
    golden_s = max(done) - t_pool
    full = ("sad", "satd", "min_sad_had")
    bad += golden_differences(
        f"(m.2) {size} the main path's minSadHad, frame 0", golden["noise"],
        {"min_sad_had": costs["main"].min_sad_had[0]},
        costs["main"].valid[0])
    bad += golden_differences(
        f"(m.3) {size} full report, frame 0", golden["noise"],
        {f: getattr(costs["full"], f)[0] for f in full},
        costs["full"].valid[0])
    bad += golden_differences(
        f"(m.4) {size} the CLI's POC 0, {FILTER[0]}[{FILTER[1]}] on the "
        f"card vs golden/filters_golden.py for the golden model, full "
        f"report", golden["cli"],
        {f: getattr(costs[FILTER], f)[0] for f in full},
        costs[FILTER].valid[0])
    bad += latency_ring_golden(noise, UHD_W, UHD_H, dev, golden["noise"],
                               "(m.7)")
    if prefix is not None:
        bad += [f"(m.5) {d}" for d in target_golden_differences(
            f"{prefix}target_ctu{target}.csv", golden["cli"], UHD_W, target,
            0, tmp)]
    del golden, costs
    print(f"golden model (m): 2 frames {size} in {golden_s:.1f} s wall "
          f"({golden_s / 2:.1f} s a frame) on {workers} spawned workers "
          f"({card})", flush=True)

    # (m.9) timings, the host quiet
    times = {(UHD_W, UHD_H, MAIN_BATCH): size_timings(
        UHD_W, UHD_H, MAIN_BATCH, dev, int_rate, card, bad, "m.9")}
    torch.cuda.empty_cache()
    filt = filter_timings(torch.from_numpy(np.random.default_rng(61).integers(
        0, 1024, (MAIN_BATCH, UHD_H, UHD_W), dtype=np.int32)).to(dev),
        FILTER, int_rate, card, "m.9")
    filt["launches"] = filter_counts[FILTER]  # (m.4)'s filtered path
    if not filt["bit_exact"]:
        bad.append("filter (m.9) differs from the plain version")
    torch.cuda.empty_cache()
    for extra in UHD_BENCH_RUNS:
        bench_against_kernels(extra, times, card, bad)
    if bad:
        failures.append(f"{size} (m): {bad}")
    wall = time.perf_counter() - t_phase
    print(f"phase (m): {wall:.1f} s ({card})", flush=True)
    return {"times": times, "golden_s": golden_s, "phase_s": wall,
            "filter": filt}


def phase_golden(frames: torch.Tensor, main_costs, card: str,
                 failures) -> dict:
    """(k) the card's costs against the port's own golden cost oracles:
    the golden model (golden/reference_model.py) at 1920x1080, its 47
    groups of each frame in a spawned process pool (the parent holds a
    CUDA context) while the card works, and the scalar oracle
    (golden/scalar_oracle.py) at 3840x2160 and at 1920x1080.  Valid CUs
    only, and each validity mask against the golden model's.  Returns
    the golden model's timing."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from vvc_mip_gpu_tpu_torch.golden.filters_golden import filter_frame
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.tools.profile_cpu_filtering import host_cpus

    t_phase = time.perf_counter()
    dev = frames.device
    # one worker a CPU this process may run on (os.cpu_count() may count
    # the whole host's, and each worker holds up to ~3 GB)
    workers = host_cpus()
    noise = frames[0].cpu().numpy().astype(np.int64)
    smooth = synthetic_frames(1, MAIN_W, MAIN_H, seed=5)[0].astype(np.int64)
    full = MipCostEngine(MAIN_W, MAIN_H)
    bad = []
    done: list[float] = []
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        t_pool = time.perf_counter()
        pending = {"noise": golden_futures(pool, noise, noise, done),
                   "smooth filtered": golden_futures(
                       pool, smooth, filter_frame(smooth, *FILTER), done)}
        # the card meanwhile: (k.1b) frame 0's full report, (k.2) the
        # smooth frame's filtered full report, (k.3) 3840x2160
        noise_full, launches = count_launches(
            lambda: full.compute_batch(frames[:1]))
        if launches != [1, 7, 9]:
            bad.append(f"(k.1) full report launches {launches}")
        smooth_card = torch.from_numpy(smooth.astype(np.int32))[None].to(dev)
        smooth_full, launches = count_launches(lambda: full.compute_batch(
            smooth_card, filter_frames(smooth_card, *FILTER)))
        if launches != [1, 7, 9]:
            bad.append(f"(k.2) filtered full report launches {launches}")
        uhd = uhd_frames()
        uhd_costs, launches = count_launches(lambda: MipCostEngine(
            UHD_W, UHD_H).compute_batch(torch.from_numpy(uhd).to(dev)))
        if launches != [1, 7, 9]:
            bad.append(f"(k.3) {UHD_W}x{UHD_H} launches {launches}")
        t0 = time.perf_counter()
        spots = spot_cus(UHD_W, UHD_H, seed=15)
        n_bottom = sum(s[0] == "bottom row" for s in spots)
        uhd_bad = []
        for b, label in enumerate(("noise", "smooth")):
            uhd_bad += [f"{label} {d}" for d in scalar_differences(
                uhd[b], spots, spot_values(uhd_costs, b, spots))]
        del uhd_costs
        print(f"check golden (k.3) {UHD_W}x{UHD_H}, noise and smooth "
              f"frames: {2 * len(spots)} (CU, mode) entries x SAD, SATD, "
              f"minSadHad ({2 * n_bottom} in the {UHD_H % 128}-row partial "
              f"bottom CTU row) vs the scalar oracle: "
              f"{'bit-exact' if not uhd_bad else uhd_bad[:5]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if uhd_bad or not n_bottom:
            bad.append(f"(k.3) {len(uhd_bad)} entries differ from the "
                       f"scalar oracle, first {uhd_bad[:3]}; {n_bottom} "
                       f"in the bottom row")
        # (k.1) frame 0 at the scalar oracle, compared below with the
        # golden model and the card
        t0 = time.perf_counter()
        spots_hd = spot_cus(MAIN_W, MAIN_H, seed=16)
        card_hd = spot_values(noise_full, 0, spots_hd)
        hd_bad = scalar_differences(noise, spots_hd, card_hd)
        oracle_s = time.perf_counter() - t0
        golden = {name: {g: f.result() for g, f in futures.items()}
                  for name, futures in pending.items()}
    # after the pool's shutdown: every completion callback has run
    golden_s = max(done) - t_pool
    bad += golden_differences(
        f"(k.1a) the main path's minSadHad, frame 0, {MAIN_W}x{MAIN_H}",
        golden["noise"], {"min_sad_had": main_costs.min_sad_had[0]},
        main_costs.valid[0])
    bad += golden_differences(
        f"(k.1b) full report, frame 0, {MAIN_W}x{MAIN_H}", golden["noise"],
        {"sad": noise_full.sad[0], "satd": noise_full.satd[0],
         "min_sad_had": noise_full.min_sad_had[0]}, noise_full.valid[0])
    bad += golden_differences(
        f"(k.2) smooth frame, {FILTER[0]}[{FILTER[1]}] on the card vs "
        f"golden/filters_golden.py for the golden model, full report",
        golden["smooth filtered"],
        {"sad": smooth_full.sad[0], "satd": smooth_full.satd[0],
         "min_sad_had": smooth_full.min_sad_had[0]}, smooth_full.valid[0])
    bad += latency_ring_golden(noise.astype(np.int32), MAIN_W, MAIN_H, dev,
                               golden["noise"], "(k.1d)")
    hd_golden = [(golden["noise"][s[2]].sad[s[1], s[3], s[6]],
                  golden["noise"][s[2]].satd[s[1], s[3], s[6]],
                  golden["noise"][s[2]].min_sad_had[s[1], s[3], s[6]])
                 for s in spots_hd]
    hd_bad += [f"golden {d}" for d in scalar_differences(noise, spots_hd,
                                                          hd_golden)]
    print(f"check golden (k.1c) {MAIN_W}x{MAIN_H} frame 0: "
          f"{len(spots_hd)} (CU, mode) entries x SAD, SATD, minSadHad of "
          f"the card and of the golden model vs the scalar oracle: "
          f"{'bit-exact' if not hd_bad else hd_bad[:5]} ({oracle_s:.1f} s)",
          flush=True)
    if hd_bad:
        bad.append(f"(k.1c) {len(hd_bad)} entries differ from the scalar "
                   f"oracle, first {hd_bad[:3]}")
    if bad:
        failures.append(f"golden (k): {bad}")
    wall = time.perf_counter() - t_phase
    print(f"golden model (k): 2 frames {MAIN_W}x{MAIN_H} in {golden_s:.1f} s "
          f"wall ({golden_s / 2:.1f} s a frame) on {workers} spawned workers, "
          f"one a CPU this process may run on (os.cpu_count() "
          f"{os.cpu_count()}); phase (k) {wall:.1f} s ({card})",
          flush=True)
    return {"golden_s_per_frame": golden_s / 2, "workers": workers,
            "phase_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from vvc_mip_gpu_tpu_torch.constants import num_ctus
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        PER_CTU, MipCostEngine, class_runs, compute_ext)
    from vvc_mip_gpu_tpu_torch.ops import _build
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS
    from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred
    from vvc_mip_gpu_tpu_torch.tools import roofline
    from vvc_mip_gpu_tpu_torch.utils.sass import (
        describe, instruction_mix, kernel_name)

    card = smi("name,power.limit")
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {props.name} "
          f"SMs {props.multi_processor_count}", flush=True)

    # ---- 1. build the kernels and the C CSV library from csrc/ (never a
    # library left by an earlier run in this tree), one compiler per
    # source, all at once
    libraries = _build.LIBRARIES + _build.HOST_LIBRARIES
    for name in libraries:
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = _build.build_libraries(libraries)
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

    for width, height in ((MAIN_W, MAIN_H), (608, 192), *REF_SIZES):
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
    if not torch.equal(msh[:2], plain_costs(f16, f16, MAIN_W, MAIN_H, 1)[0]):
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
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = roofline.int32_rate(props.multi_processor_count, clock_mhz)
    print(f"bound rates: int32 {int_rate / 1e12:.2f} Tops/s "
          f"({roofline.INT32_OPS_PER_CLK_PER_SM}/clk/SM x "
          f"{props.multi_processor_count} SMs x {clock_mhz:.0f} MHz), "
          f"memory {roofline.HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    per_kernel = class_times(f16, MAIN_W, MAIN_H, int_rate, failures)

    # ---- 4-8. the prediction kernel, the filters, the filtered full
    # report, the inspect readback and the CLI (its files kept for (f))
    noise16 = f16[0]
    smooth16 = torch.from_numpy(synthetic_frames(
        1, MAIN_W, MAIN_H, seed=5)[0].astype(np.int16)).to(dev)
    pred = phase_pred(noise16, smooth16, int_rate, failures)
    filt = phase_filters(frames, int_rate, card, failures)
    filt["launches"] = phase_filtered_full(frames, failures)
    pred_launches = phase_inspect(failures)
    with tempfile.TemporaryDirectory() as tmp:
        cli_args = phase_cli(card, tmp, failures)
        # ---- 9. (f) the multi-device engines and the multi-process CLI
        mesh_ms = phase_sharded(frames, msh, card, failures)
        latency_ms = phase_latency(
            np.random.default_rng(9).integers(
                0, 1024, (MAIN_H, MAIN_W)).astype(np.int32), dev, card,
            failures)
        latency_wall = phase_cli_latency(cli_args, tmp, card, failures)
        cli_wall = phase_cli_processes(cli_args, tmp, card, failures)
        case_walls = phase_cli_process_cases(tmp, card, failures)
        # ---- 10. (g) frame CSV I/O, (h) energy, the roofline tool
        phase_frame_io(tmp, card, failures)
        energy = phase_energy(tmp, card, failures)
    phase_roofline(per_kernel, card, failures)
    # ---- 11. (i) 3840x2160 bit-exact, then the bench in every mode
    phase_bench(batch, frames, msh, phase_uhd(dev, failures), card,
                failures)
    # ---- 12. (j) the in-context profiler and the CPU filtering sweep
    incontext = phase_profiles(frames, per_kernel, card, failures)
    # ---- 13. (l) the reference's other three frame sizes
    with tempfile.TemporaryDirectory() as tmp:
        reference = phase_reference(tmp, dev, card, int_rate, failures)
    # ---- 14. (m) 3840x2160 through every entry point
    with tempfile.TemporaryDirectory() as tmp:
        uhd = phase_uhd_entry_points(tmp, dev, card, int_rate, failures)
    # ---- 15. (k) the card's costs against the golden cost oracles, where
    # no phase times the host
    golden = phase_golden(frames, costs, card, failures)
    print(f"(f) beside the main path's {batch:.3f} ms per batch of "
          f"{MAIN_BATCH} ({card}):")
    for name, ms in mesh_ms.items():
        print(f"  sharded {name}: {ms:.3f} ms per batch ({card})")
    for name, ms in latency_ms.items():
        print(f"  single-frame latency {name}: {ms:.3f} ms ({card})")
    print(f"  CLI --LatencyMode: {latency_wall:.2f} s wall ({card})")
    print(f"  two-process CLI: {cli_wall:.2f} s wall ({card})")
    for name, wall in case_walls.items():
        print(f"  two-process CLI, {name}: {wall:.2f} s wall ({card})")
    for n, joules in energy.items():
        print(f"  (h) energy, {n} frame(s): {joules:.2f} J per frame "
              f"({card})", flush=True)
    for b, ms in incontext.items():
        print(f"  (j) in-context search, batch {b}: {ms:.4f} ms per frame "
              f"({card})", flush=True)
    for phase, result in (("l", reference), ("m", uhd)):
        for (w, h, b), t in result["times"].items():
            print(f"  ({phase}) {w}x{h} main path, batch {b}: "
                  f"{t['e2e_ms']:.4f} ms, {b * 1e3 / t['e2e_ms']:.1f} "
                  f"frames/s; the card busy {t['busy_ms']:.4f} ms, its 17 "
                  f"cost kernels {t['cost_kernels_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms; idle "
                  f"{1 - t['busy_ms'] / t['e2e_ms']:.1%} ({card})")
        print(f"  ({phase}) golden model {result['golden_s']:.1f} s, phase "
              f"{result['phase_s']:.1f} s ({card})")
    print(f"  (k) golden model {golden['golden_s_per_frame']:.1f} s a "
          f"{MAIN_W}x{MAIN_H} frame on {golden['workers']} workers, phase "
          f"{golden['phase_s']:.1f} s ({card})", flush=True)
    if failures:
        print("FAILED:", *failures, sep="\n  ", file=sys.stderr)
        return 1

    rows = []
    for k in KERNELS:
        agg = per_kernel[k.name]
        bound_ms, bound_by = roofline.bound(agg["ops"], agg["bytes"],
                                            int_rate)
        rows.append({
            "name": k.name, "route": "cuda", "source": SOURCE,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max_err[k.name], "ms": round(agg["ms"], 4),
            "plain_ms": round(agg["plain_ms"], 2),
            "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
            "library_ms": None, "bit_exact": max_err[k.name] == 0,
            "classes_ms": agg["classes"],
            "classes_bound_ms": agg["class_bounds"],
            "shape": f"{MAIN_BATCH}x{MAIN_W}x{MAIN_H}"})
    bound_ms, bound_by = roofline.bound(pred["ops"], pred["bytes"], int_rate)
    rows.append({
        "name": "mip_reduced_pred", "route": "cuda", "source": PRED_SOURCE,
        "replaces": mip_reduced_pred.replaces, "launches": pred_launches,
        "max_abs_err": pred["max_err"], "ms": round(pred["ms"], 4),
        "plain_ms": round(pred["plain_ms"], 3),
        "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
        "library_ms": None, "bit_exact": pred["max_err"] == 0,
        "sizeid_ms": pred["sizeid_ms"],
        "cublas_fp32_product_ms": round(pred["cublas"], 4),
        "shape": f"all CUs of one {MAIN_W}x{MAIN_H} frame, SizeId 0-2"})
    for shape, t in ((f"{MAIN_BATCH}x{MAIN_W}x{MAIN_H}", filt),
                     (f"{MAIN_BATCH}x{UHD_W}x{UHD_H}", uhd["filter"])):
        rows.append({
            "name": "mip_filter", "route": "cuda", "source": FILTER_SOURCE,
            "replaces": filter_frames.replaces, "launches": t["launches"],
            "ms": round(t["ms"], 4), "plain_ms": round(t["plain_ms"], 3),
            "bound_ms": round(t["bound_ms"], 4), "bound_by": t["bound_by"],
            "library_ms": None, "bit_exact": t["bit_exact"],
            "shape": f"{shape} {FILTER[0]}[{FILTER[1]}]"})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
