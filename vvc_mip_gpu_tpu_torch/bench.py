"""The port's benchmark: MIP mode-search throughput and latency on one CUDA
card.

The counterpart of the repository's ``bench.py`` (the JAX package's), with
its flags, defaults, frames and metric names::

    python -m vvc_mip_gpu_tpu_torch.bench [--resolution WxH] [--batch B]
        [--iters N] [--filtered] [--window {compute,reference,r1}]
        [--with-export] [--latency]

It prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``
(the value against ``bench.py``'s assumed 60 frames/s OpenCL figure, an
assumption kept for the contract, not a measurement), ``device`` (the
card's name and power limit as ``nvidia-smi`` gives them, or "cpu"),
``launches`` (each cost kernel's launches in the measured part of the
run), ``peak_memory_bytes`` (the caching allocator's peak on the card) and
each mode's own fields.  It runs on the CUDA card (every visible card for
``--latency``); with VVC_MIP_PLATFORM=cpu in the environment on the CPU,
through the kernels' plain versions; with neither it raises, as the CLI
does.  A failure prints an error record (``value`` null) and exits 1:
nothing is retried, and nothing falls back to the CPU or to a plain
version.

Every mode searches distinct 10-bit frames, made from seed 0, with only
minSadHad out (the reference's MAX_PERFORMANCE_DIST, as ``bench.py``):

- compute (the headline): each of three windows is ``--iters`` batches,
  each the resident batch XOR a per-frame salt written into one reused
  buffer (frame i of a window is ``frames[i % B] ^ ((salt + i) & 1023)``,
  ``bench.py``'s on-device loop); each result's nonzero count goes into
  an int64 accumulator on the device.  The three windows are enqueued
  back to back and each accumulator is read once at the end: frames/s
  over the host's wall time, and ``device_ms_per_batch`` from CUDA events
  over the same windows.  ``--filtered`` low-pass filters each batch on
  the device first (filterFrame_2d_int_quarterCtu, KernelIdx 2).
- ``--window reference``: the reference's write->compute->read window,
  two deep: 2-byte samples XORed on the host into pinned buffers and
  uploaded, the search,
  and the whole [B, nCTU, 97840] minSadHad read back into the CLI's
  pinned readback ring on a copy stream of its own, so that batch i's
  readback overlaps batch i+1's search; ``pipeline`` gives their CUDA
  event spans and overlap.  Then one unpipelined pass, decomposed into
  upload, compute and read (seconds, bytes, MB/s).
- ``--window r1``: ``--iters`` host-dispatched batches, each frames XOR a
  constant, their counts read after all are dispatched.
- ``--with-export``: ``--iters`` batches, the last one read back into the
  ring, then ONE decisions CSV of its last frame through the C writer
  (one log per run, as the reference writes).
- ``--latency``: one frame through LatencyMipCostEngine (the CLI's
  --LatencyMode: dispatch, then gather and the readback ring),
  best of 8 salted frames, with the device's own time per search from
  CUDA events over 16 searches on one card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.cli import local_devices
from vvc_mip_gpu_tpu_torch.io.export import export_decisions_csv
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.ops._build import load_library
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine
from vvc_mip_gpu_tpu_torch.parallel.mesh import on_stream, shard_stream
from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

ASSUMED_BASELINE_FPS = 60.0  # bench.py's assumed OpenCL 1080p figure
WIDTH, HEIGHT = 1920, 1080
BATCH = 16
ITERS = 6
WARMUP = 1  # warm-up runs after the first, which loads the libraries
WINDOWS = 3  # timed windows of the compute mode
LATENCY_FRAMES = 8
IN_LOOP_SEARCHES = 16
FILTER = ("filterFrame_2d_int_quarterCtu", 2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vvc-mip-gpu-bench",
        description="MIP mode-search throughput and latency on a CUDA card; "
                    "prints one JSON line")
    p.add_argument("--resolution", default=None,
                   help="WxH (default 1920x1080; e.g. 3840x2160)")
    p.add_argument("--batch", type=int, default=None,
                   help=f"frames per batch (default {BATCH})")
    p.add_argument("--iters", type=int, default=None,
                   help=f"batches per timed window (default {ITERS})")
    p.add_argument("--filtered", action="store_true",
                   help="alternative-samples regime: low-pass filter each "
                        "batch on the device, then search against it")
    p.add_argument("--with-export", action="store_true",
                   help="time --iters batches, the last one's readback and "
                        "one decisions CSV of its last frame")
    p.add_argument("--latency", action="store_true",
                   help="single-frame time to host costs through the "
                        "class-sharded latency engine, in ms")
    p.add_argument("--window", choices=["compute", "reference", "r1"],
                   default="compute",
                   help="'compute': steady-state window (the headline); "
                        "'reference': write->compute->read with the whole "
                        "cost tensor read back; 'r1': host-dispatched "
                        "batches, counts read after all")
    return p


def metric_name(args) -> str:
    """``bench.py``'s metric name for the same flags."""
    tag = args.resolution or "1080p"
    if args.latency:
        return f"mip_search_{tag}_single_frame_latency_ms"
    name = f"mip_search_{tag}"
    if args.window == "reference":
        name += "_refwindow"
    elif args.window == "r1":
        name += "_r1window"
    elif args.filtered:
        name += "_filtered"
    if args.with_export:
        name += "_with_export"
    return name + "_frames_per_second"


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "-i", str(device.index),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def searcher(engine: MipCostEngine, filtered: bool):
    """batch -> minSadHad [B, nCTU, 97840] of ``engine`` (max-performance),
    against the filtered batch with ``filtered``."""
    def search(frames):
        refs = filter_frames(frames, *FILTER) if filtered else None
        return engine.compute_batch(frames, refs).min_sad_had
    return search


def salted_batches(frames: torch.Tensor, salt: int, iters: int,
                   out: torch.Tensor):
    """The ``iters`` batches of one compute window, each written into
    ``out`` (``frames``' shape and type) and yielded: frame i of the
    window (row i % B of batch i // B) is frames[i % B] ^ ((salt + i) &
    1023)."""
    b = frames.shape[0]
    salts = (torch.arange(iters * b, dtype=frames.dtype, device=frames.device)
             .view(iters, b, 1, 1) + salt) & 1023
    for k in range(iters):
        torch.bitwise_xor(frames, salts[k], out=out)
        yield out


def count_window(search, frames: torch.Tensor, salt: int, iters: int,
                 out: torch.Tensor) -> torch.Tensor:
    """The nonzero minSadHad entries of one compute window, counted into an
    int64 scalar on the device and not read."""
    acc = torch.zeros((), dtype=torch.int64, device=frames.device)
    for batch in salted_batches(frames, salt, iters, out):
        acc += torch.count_nonzero(search(batch))
    return acc


def _event(device: torch.device):
    """A timing event recorded on ``device``'s current stream; None on the
    CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _zero_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def _bench_compute(search, frames_np, device, iters) -> tuple[float, dict]:
    frames = torch.from_numpy(frames_np).to(device)
    out = torch.empty_like(frames)
    for salt in range(1 + WARMUP):
        count_window(search, frames, salt, iters, out).item()
    _sync(device)
    _zero_launches()
    t0 = time.perf_counter()
    start = _event(device)
    accs = [count_window(search, frames, WARMUP + 1 + j, iters, out)
            for j in range(WINDOWS)]
    end = _event(device)
    checksum = sum(acc.item() for acc in accs)
    wall = time.perf_counter() - t0
    if checksum == 0:
        raise RuntimeError("compute window: every minSadHad entry is 0")
    _sync(device)
    n_batches = WINDOWS * iters
    return n_batches * frames.shape[0] / wall, {
        "device_ms_per_batch": (None if start is None else round(
            start.elapsed_time(end) / n_batches, 4))}


def _bench_r1(search, frames_np, device, iters) -> tuple[float, dict]:
    frames = torch.from_numpy(frames_np).to(device)

    def count(salt):
        return torch.count_nonzero(search(frames ^ salt))

    for salt in range(1 + WARMUP):
        count(salt).item()
    _zero_launches()
    t0 = time.perf_counter()
    outs = [count(WARMUP + 1 + i) for i in range(iters)]
    checksum = sum(o.item() for o in outs)
    wall = time.perf_counter() - t0
    if checksum == 0:
        raise RuntimeError("r1 window: every minSadHad entry is 0")
    return iters * frames.shape[0] / wall, {}


def _overlap(spans) -> dict | None:
    """Mean CUDA-event ms per batch of the search, of its readback, and of
    the part of each readback that ran during the next batch's search;
    None on the CPU.  ``spans``: (search, read, next search) event pairs,
    the last without a next search."""
    if spans[0][0][0] is None:
        return None
    base = spans[0][0][0]

    def at(event):
        return base.elapsed_time(event)

    n = len(spans)
    search = sum(at(s[1]) - at(s[0]) for s, _, _ in spans) / n
    read = sum(at(r[1]) - at(r[0]) for _, r, _ in spans) / n
    over = sum(max(0.0, min(at(r[1]), at(nx[1])) - max(at(r[0]), at(nx[0])))
               for _, r, nx in spans if nx is not None) / n
    return {"search_ms_per_batch": round(search, 4),
            "read_ms_per_batch": round(read, 4),
            "read_during_next_search_ms_per_batch": round(over, 4)}


def _bench_reference(search, frames_np, device, iters) -> tuple[float, dict]:
    frames_u16 = frames_np.astype(np.uint16)
    ring = ReadbackRing()
    copy_stream = shard_stream(device)
    # Two host buffers for the uploads, pinned on the card, taken in turn.
    # The values are below 1024, so the buffers' int16 samples (what the
    # engine searches) are the uint16 samples.  Batch k's buffer is
    # written again by batch k + 2, whose upload starts after batch k's
    # readback, which waited for batch k's search and so for its upload.
    staging = itertools.cycle([
        torch.empty(frames_u16.shape, dtype=torch.int16,
                    pin_memory=device.type == "cuda") for _ in range(2)])

    def upload(salt):
        """The reference's 2-byte samples, XORed on the host."""
        host = next(staging)
        np.bitwise_xor(frames_u16, np.uint16(salt),
                       out=host.numpy().view(np.uint16))
        return host.to(device, non_blocking=True)

    def step(salt):
        """Upload and search one batch; (minSadHad, its search's events)."""
        batch = upload(salt)
        start = _event(device)
        return search(batch), (start, _event(device))

    def read(msh, span):
        """``msh`` into the ring on the copy stream once its search is done
        (the compute stream goes on with the next batch); (whether its
        last CTU holds a nonzero cost, the readback's events)."""
        if copy_stream is not None:
            copy_stream.wait_event(span[1])
            msh.record_stream(copy_stream)
        with on_stream(copy_stream):
            start = _event(device)
            (host,) = ring.read(msh)
            end = _event(device)
        return bool(host[-1, -1].any()), (start, end)

    for _ in range(1 + WARMUP):  # the libraries, and both ring slots
        read(*step(0))
    _zero_launches()
    t0 = time.perf_counter()
    good = 0
    spans = []
    prev = step(1)
    for i in range(1, iters + 1):
        cur = step(i + 1) if i < iters else None
        ok, read_span = read(*prev)
        good += ok
        spans.append((prev[1], read_span, None if cur is None else cur[1]))
        prev = cur
    wall = time.perf_counter() - t0
    if good != iters:
        raise RuntimeError(f"reference window: {iters - good} of {iters} "
                           f"batches read back all-zero costs")
    _sync(device)
    pipeline = _overlap(spans)
    # one batch unpipelined: where the window's time goes
    t1 = time.perf_counter()
    batch = upload(99)
    _sync(device)
    t2 = time.perf_counter()
    msh = search(batch)
    _sync(device)
    t3 = time.perf_counter()
    (host,) = ring.read(msh)
    t4 = time.perf_counter()
    up, rd = frames_u16.nbytes, host.nbytes
    return iters * frames_np.shape[0] / wall, {
        "pipeline": pipeline,
        "decomposition_per_batch": {
            "upload_s": round(t2 - t1, 4),
            "compute_s": round(t3 - t2, 4),
            "read_s": round(t4 - t3, 4),
            "upload_bytes": up,
            "read_bytes": rd,
            "upload_mb_s": round(up / 1e6 / max(t2 - t1, 1e-9), 1),
            "read_mb_s": round(rd / 1e6 / max(t4 - t3, 1e-9), 1)}}


def _bench_with_export(search, frames_np, device, iters, width
                       ) -> tuple[float, dict]:
    frames = torch.from_numpy(frames_np).to(device)
    ring = ReadbackRing()
    for salt in range(1 + WARMUP):  # the libraries, and both ring slots
        ring.read(search(frames ^ salt))
    load_library("io_native")
    outdir = tempfile.mkdtemp(prefix="benchx_")
    path = os.path.join(outdir, "decisions.csv")
    try:
        _zero_launches()
        t0 = time.perf_counter()
        last = None
        for i in range(iters):
            last = search(frames ^ (i + 1))
        (msh,) = ring.read(last)
        t1 = time.perf_counter()
        export_decisions_csv(path, msh[-1], width)
        t2 = time.perf_counter()
        csv_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    n_frames = iters * frames.shape[0]
    return n_frames / (t2 - t0), {"export": {
        "compute_and_read_s": round(t1 - t0, 4),
        "export_s": round(t2 - t1, 4),
        "csv_bytes": csv_bytes,
        "export_mb_s": round(csv_bytes / 1e6 / max(t2 - t1, 1e-9), 1),
        "frames": n_frames}}


def _bench_latency(width, height, devices) -> tuple[float, dict]:
    engine = LatencyMipCostEngine(width, height, devices, max_performance=True)
    ring = ReadbackRing()
    frame_np = np.random.default_rng(0).integers(
        0, 1024, size=(height, width), dtype=np.int32)

    def assemble(outs):
        """The CLI's latency read: gather and the readback ring."""
        return engine.assemble(outs, ring.read)

    for _ in range(1 + WARMUP):  # the libraries, streams and ring slots
        assemble(engine.dispatch(frame_np))
    _zero_launches()
    best_wall = best_dispatch = best_assemble = float("inf")
    for i in range(LATENCY_FRAMES):
        frame = frame_np ^ (i + 1)
        t0 = time.perf_counter()
        outs = engine.dispatch(frame)
        t1 = time.perf_counter()
        costs = assemble(outs)
        t2 = time.perf_counter()
        if not costs.min_sad_had.numel():
            raise RuntimeError("latency: empty costs")
        best_wall = min(best_wall, t2 - t0)
        best_dispatch = min(best_dispatch, t1 - t0)
        best_assemble = min(best_assemble, t2 - t1)
    in_loop_ms = None
    device = devices[0]
    if device.type == "cuda":
        # the search alone on the card: CUDA events over k searches
        single = MipCostEngine(width, height, max_performance=True,
                               device=device)
        x = torch.from_numpy(frame_np).to(device)
        single(x)
        runs = []
        for j in range(4):
            y = x ^ (j + 2)
            start = _event(device)
            for i in range(IN_LOOP_SEARCHES):
                single(y ^ i)
            end = _event(device)
            end.synchronize()
            runs.append(start.elapsed_time(end) / IN_LOOP_SEARCHES)
        in_loop_ms = round(min(runs), 4)
    return best_wall * 1e3, {"decomposition": {
        "dispatch_ms": round(best_dispatch * 1e3, 4),
        "assemble_ms": round(best_assemble * 1e3, 4),
        "in_loop_compute_ms": in_loop_ms,
        "n_devices": len(devices)}}


def frame_size(args) -> tuple[int, int]:
    if args.resolution is None:
        return WIDTH, HEIGHT
    w, h = args.resolution.lower().split("x")
    return int(w), int(h)


def run(args) -> dict:
    """The record of one bench run (raises on any failure)."""
    width, height = frame_size(args)
    batch, iters = args.batch or BATCH, args.iters or ITERS
    devices = local_devices(1)  # raises without a card, as the CLI does
    device = devices[0]
    if device.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist from here on
        torch.cuda.reset_peak_memory_stats(device)
    if args.latency:
        ms, fields = _bench_latency(width, height, devices)
        value, vs = ms, 1e3 / ASSUMED_BASELINE_FPS / ms
    else:
        engine = MipCostEngine(width, height, max_performance=True,
                               device=device)
        search = searcher(engine, args.filtered)
        frames_np = np.random.default_rng(0).integers(
            0, 1024, size=(batch, height, width), dtype=np.int32)
        if args.with_export:
            value, fields = _bench_with_export(search, frames_np, device,
                                               iters, width)
        elif args.window == "reference":
            value, fields = _bench_reference(search, frames_np, device, iters)
        elif args.window == "r1":
            value, fields = _bench_r1(search, frames_np, device, iters)
        else:
            value, fields = _bench_compute(search, frames_np, device, iters)
        vs = value / ASSUMED_BASELINE_FPS
    return {
        "metric": metric_name(args),
        "value": round(value, 3),
        "unit": "ms" if args.latency else "frames/s",
        "vs_baseline": round(vs, 3),
        "device": device_label(device),
        **fields,
        "launches": {k.name: k.launches for k in KERNELS},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None)}


def _emit(record: dict) -> None:
    """Print the one JSON line, stamped with the round tag (environment
    VVC_BENCH_ROUND) and the UTC date."""
    tag = os.environ.get("VVC_BENCH_ROUND")
    if tag:
        record["round"] = tag
    record["date"] = time.strftime("%Y-%m-%d", time.gmtime())
    print(json.dumps(record), flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        record = run(args)
    except Exception as err:  # the entry point's boundary: report, exit 1
        traceback.print_exc()
        _emit({"metric": metric_name(args), "value": None,
               "unit": "ms" if args.latency else "frames/s",
               "vs_baseline": None,
               "error": f"{type(err).__name__}: {err}"[:300]})
        return 1
    _emit(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
