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
  frames) into a temporary directory, its CSVs, written by the C writer
  (csrc/io_native.c), checked against the card's costs and frame 0's
  against the numpy writer's bytes, both writers timed;
- (f) the multi-device engines on this one card: the sharded engine
  (meshes (1, 1) and (2, 2) on the main path's batch, and (1, 2) in the
  filtered full report, whose bands meet at a filtered halo row) against
  MipCostEngine on the edge-padded and on the true frames; the latency
  engine on one frame with 1 part and with 4 parts on 4 streams, both
  regimes; the CLI's latency path, which reads back through the pinned
  readback ring, and two CLI processes (gloo on localhost) with (e)'s
  flags, whose CSVs must equal (e)'s byte for byte (then all are
  deleted); each timed (ms per batch, single-frame latency host to host
  and by step, the readback into new pageable memory and into the ring,
  CLI wall time);
- (g) the C frame-CSV writer and reader against the numpy ones on 16
  frames, byte for byte and sample for sample, timed;
- (h) the port's power tracer (tools/power_tracer.py, nvidia-smi as the
  meter) on the CLI at 1920x1080, max-performance, 1 and 2 frames, and
  its energy analysis (tools/compute_energy.py): every stage marker
  paired, a power sample inside the search, joules per stage and frame;
- the roofline tool's per-class bounds (tools/roofline.py, the op model
  of every bound here) against the ones this run reports.

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
FRAME_IO_FRAMES = 16  # phase (g)
ENERGY_FRAMES = 2  # phase (h): the tracer's sweep, 1..ENERGY_FRAMES
# the pageable readback of the same 52.8 MB before the ring (PERF.md §5)
EARLIER_PAGEABLE_READBACK_MS = 27.941
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
    counters set to 0 just before, read just after a synchronize."""
    from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
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


def phase_sharded(frames: torch.Tensor, main_msh: torch.Tensor, card: str,
                  failures) -> dict:
    """(f.1) ShardedMipCostEngine on this one card over the main path's
    batch: the (1, 1) mesh and the (2, 2) mesh (four shards on four
    streams, real halo rows) max-performance, then the (1, 2) mesh in the
    filtered full report, whose band 1 reads band 0's last FILTERED row.
    Each against MipCostEngine on the edge-padded frames (whole padded
    tensors) and on the true frames (valid CUs of the true CTUs; the main
    path's minSadHad for max-performance), its mask against
    _validity_mask_np and its launches against n_shards x (1, 7, 9); then
    timed.  Returns {mesh: ms per batch}."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import (
        FrameCosts, MipCostEngine, _validity_mask)
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.parallel import ShardedMipCostEngine, make_mesh
    from vvc_mip_gpu_tpu_torch.parallel.sharded_engine import (
        _validity_mask_np)

    dev = frames.device
    valid = torch.from_numpy(_validity_mask(MAIN_W, MAIN_H)).to(dev)
    n_ctu = valid.shape[0]
    refs = filter_frames(frames, *FILTER)
    full_true = MipCostEngine(MAIN_W, MAIN_H).compute_batch(frames, refs)
    times = {}
    for n_data, n_space, mp in ((1, 1, True), (2, 2, True), (1, 2, False)):
        name = (f"({n_data}, {n_space}) "
                f"{'max-performance' if mp else 'filtered full report'}")
        mesh = make_mesh(n_data, n_space, [dev] * (n_data * n_space))
        engine = ShardedMipCostEngine(MAIN_W, MAIN_H, mesh,
                                      max_performance=mp)
        ref = None if mp else refs
        got, launches = count_launches(lambda: engine(frames, ref))
        n = n_data * n_space
        fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
        padded = MipCostEngine(MAIN_W, engine.padded_height,
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
        mask_ok = np.array_equal(got.valid.cpu().numpy(), _validity_mask_np(
            MAIN_W, MAIN_H, engine.padded_height))
        if not mask_ok:
            bad.append("validity mask")
        if launches != [n, 7 * n, 9 * n]:
            bad.append(f"launches {launches}, want {[n, 7 * n, 9 * n]}")
        if bad:
            failures.append(f"sharded {name}: {bad}")
        print(f"check sharded {name}, padded to {engine.padded_height} rows: "
              f"launches {launches}; whole padded tensors vs MipCostEngine "
              f"on edge-padded frames, valid CUs of the true CTUs vs "
              f"MipCostEngine, mask: {'bit-exact' if not bad else bad}",
              flush=True)
        del got, got_true
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


def phase_latency(frame: np.ndarray, dev: torch.device, card: str,
                  failures) -> dict:
    """(f.2) LatencyMipCostEngine on one 1080p host frame with [dev]
    (1 part) and [dev] x 4 (4 parts on 4 streams), max-performance on
    the original samples and the full report on the filtered reference:
    whole tensors against MipCostEngine(frame), one launch per class in
    all.  Then single-frame latency, host frame to host arrays, median
    of 10: MipCostEngine and both latency engines, max-performance.
    Returns {engine: ms}."""
    from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
    from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
    from vvc_mip_gpu_tpu_torch.parallel.latency_engine import (
        LatencyMipCostEngine)
    from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

    filtered = filter_frames(torch.from_numpy(frame)[None].to(dev),
                             *FILTER)[0].cpu().numpy()
    engines = {}
    for mp, ref in ((True, None), (False, filtered)):
        fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
        want = MipCostEngine(MAIN_W, MAIN_H, max_performance=mp)(frame, ref)
        for n_parts in (1, 4):
            engine = LatencyMipCostEngine(MAIN_W, MAIN_H, [dev] * n_parts,
                                          max_performance=mp)
            engines[n_parts, mp] = engine
            got, launches = count_launches(lambda: engine(frame, ref))
            bad = differing(got, want, fields)
            if launches != [1, 7, 9]:
                bad.append(f"launches {launches}, want [1, 7, 9]")
            if got.min_sad_had.device.type != "cpu":
                bad.append("costs not on the host")
            label = (f"{n_parts} part(s), "
                     f"{'max-performance' if mp else 'filtered full report'}")
            if bad:
                failures.append(f"latency {label}: {bad}")
            print(f"check latency {label}: launches {launches}; whole "
                  f"tensors vs MipCostEngine(frame): "
                  f"{'bit-exact' if not bad else bad}", flush=True)
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
    int_rate = roofline.int32_rate(props.multi_processor_count, clock_mhz)
    print(f"bound rates: int32 {int_rate / 1e12:.2f} Tops/s "
          f"({roofline.INT32_OPS_PER_CLK_PER_SM}/clk/SM x "
          f"{props.multi_processor_count} SMs x {clock_mhz:.0f} MHz), "
          f"memory {roofline.HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    per_kernel = {k.name: {"ms": 0.0, "plain_ms": 0.0, "ops": 0, "bytes": 0,
                           "classes": {}, "class_bounds": {}}
                  for k in KERNELS}
    # the op model's work per class (tools/roofline.py), the runs' order
    work = roofline.class_work(MAIN_W, MAIN_H, MAIN_BATCH)
    for run, cw in zip(runs, work):
        s = run.plan.shape
        args = (f16, f16, halo16, True, run.plan, run.table, run.weights,
                [out])
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
        print(f"class {s.width}x{s.height} {run.kernel.name}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
              f"({ops / 1e9:.2f} G int ops, {nbytes / 1e6:.1f} MB), "
              f"{ms / bound:.2f}x the bound, 1 launch per batch", flush=True)

    # ---- 4-8. the prediction kernel, the filters, the filtered full
    # report, the inspect readback and the CLI (its files kept for (f))
    noise16 = f16[0]
    smooth16 = torch.from_numpy(synthetic_frames(
        1, MAIN_W, MAIN_H, seed=5)[0].astype(np.int16)).to(dev)
    pred = phase_pred(noise16, smooth16, int_rate, failures)
    phase_filters(frames, failures)
    phase_filtered_full(frames, failures)
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
        # ---- 10. (g) frame CSV I/O, (h) energy, the roofline tool
        phase_frame_io(tmp, card, failures)
        energy = phase_energy(tmp, card, failures)
    phase_roofline(per_kernel, card, failures)
    print(f"(f) beside the main path's {batch:.3f} ms per batch of "
          f"{MAIN_BATCH} ({card}):")
    for name, ms in mesh_ms.items():
        print(f"  sharded {name}: {ms:.3f} ms per batch ({card})")
    for name, ms in latency_ms.items():
        print(f"  single-frame latency {name}: {ms:.3f} ms ({card})")
    print(f"  CLI --LatencyMode: {latency_wall:.2f} s wall ({card})")
    print(f"  two-process CLI: {cli_wall:.2f} s wall ({card})")
    for n, joules in energy.items():
        print(f"  (h) energy, {n} frame(s): {joules:.2f} J per frame "
              f"({card})", flush=True)
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
