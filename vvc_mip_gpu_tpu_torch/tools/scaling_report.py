"""Multi-device scaling report of the port: frames/s and efficiency
across mesh shapes, single-frame latency over class-sharded parts, and
the CLI over several processes.

The counterpart of the JAX package's tools/scaling_report.py over the
port's engines.  Efficiency is fps(N) / (N * fps(1)).

- Default: every (data, space) factorization of N devices (data a power
  of two) through ``parallel.make_mesh`` and ``ShardedMipCostEngine``,
  max-performance, over a batch of uniform-random frames (padded to a
  multiple of the data axis), against ``MipCostEngine`` on one device.
- ``--latency``: one frame through ``MipCostEngine``, then through
  ``LatencyMipCostEngine`` with n parts and the space-banded
  ``ShardedMipCostEngine`` (1, n) for n = 2, 4, 8 up to N; ms and
  overhead t_n / t_1.
- ``--processes N``: the CLI through ``parallel.distributed.launch_cli``
  with 1 and N processes (``--batch`` frames each, CSVs into a temporary
  directory); fps from each process's ENQUEUE KERNELS + READ DISTORTION
  stage totals, the slowest process counting.  Those stages hold each
  run's first-call setup (loading the kernel library, uploading the CU
  tables; one process builds the library before the others start), so
  a small batch measures that setup more than the search.

Devices: every visible CUDA device; ``--devices N`` asks for N.  With
fewer cards than N on a one-card machine the N devices are cuda:0
repeated, one CUDA stream each, and the report says so: it then measures
the engines' overhead and overlap on one card, not a multi-device
speed-up.  With VVC_MIP_PLATFORM=cpu the CPU stands in for each device
(the numbers then measure the harness).  Times: CUDA events after a
warm-up run on a card, the host clock on the CPU.

    python -m vvc_mip_gpu_tpu_torch.tools.scaling_report -s 1920x1080 \\
        --batch 16 --devices 4 [--latency | --processes 2]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
import time

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.cli import local_devices
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.parallel import ShardedMipCostEngine, make_mesh
from vvc_mip_gpu_tpu_torch.parallel.distributed import launch_cli
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine


def factorizations(n: int) -> list[tuple[int, int]]:
    """(data, space) with data a power of two dividing n."""
    out = []
    d = 1
    while d <= n:
        if n % d == 0:
            out.append((d, n // d))
        d *= 2
    return out


def devices(n: int | None) -> tuple[list[torch.device], str]:
    """(the devices of an N-device run, what they are)."""
    devs = local_devices(n or 1)
    if devs[0].type == "cpu":
        return devs, f"the CPU standing in for {len(devs)} devices"
    n = n or len(devs)
    if n <= len(devs):
        return devs[:n], f"{n} CUDA devices"
    if len(devs) > 1:
        raise ValueError(f"--devices {n}: the machine has {len(devs)} cards")
    return devs * n, (f"streams on one card: {n} x {devs[0]} "
                      f"({torch.cuda.get_device_name(devs[0])}), no "
                      f"multi-device speed-up measured")


def timed_ms(fn, iters: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn``: CUDA events on ``device`` after one
    warm-up run, else the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mesh_report(w: int, h: int, batch: int, iters: int,
                devs: list[torch.device]) -> dict:
    dev0 = devs[0]
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1024, (batch, h, w), dtype=np.int32)).to(dev0)
    single = MipCostEngine(w, h, max_performance=True, device=dev0)
    fps1 = batch / timed_ms(lambda: single.compute_batch(frames), iters,
                            dev0) * 1e3
    rows = [{"mesh": "1 device", "frames": batch, "fps": fps1,
             "efficiency": 1.0}]
    for n_data, n_space in factorizations(len(devs)):
        if n_data * n_space == 1:
            continue
        engine = ShardedMipCostEngine(
            w, h, make_mesh(n_data, n_space, devs), max_performance=True)
        n = -(-batch // n_data) * n_data
        padded = frames[torch.arange(n, device=dev0) % batch]
        fps = n / timed_ms(lambda: engine(padded), iters, dev0) * 1e3
        rows.append({"mesh": f"data={n_data} space={n_space}", "frames": n,
                     "fps": fps,
                     "efficiency": fps / (fps1 * n_data * n_space)})
    return {"rows": rows}


def latency_report(w: int, h: int, iters: int,
                   devs: list[torch.device]) -> dict:
    dev0 = devs[0]
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1024, (h, w), dtype=np.int32)).to(dev0)
    single = MipCostEngine(w, h, max_performance=True, device=dev0)
    t1 = timed_ms(lambda: single(frame), iters, dev0)
    rows = [{"engine": "single-device", "devices": 1, "ms": t1,
             "overhead": 1.0}]
    for n in (2, 4, 8):
        if n > len(devs):
            break
        lat = LatencyMipCostEngine(w, h, devs[:n])
        t = timed_ms(lambda: lat.gather(lat.dispatch(frame)), iters, dev0)
        rows.append({"engine": "class-sharded", "devices": n, "ms": t,
                     "overhead": t / t1})
        banded = ShardedMipCostEngine(w, h, make_mesh(1, n, devs[:n]),
                                      max_performance=True)
        t = timed_ms(lambda: banded(frame[None]), iters, dev0)
        rows.append({"engine": "space-banded", "devices": n, "ms": t,
                     "overhead": t / t1})
    return {"mode": "latency", "rows": rows}


_STAGE = re.compile(r"^\s+(ENQUEUE KERNELS|READ DISTORTION)\s+total\s+"
                    r"([0-9.]+) ms", re.M)


def processes_report(resolution: str, batch: int, n_proc: int) -> dict:
    """fps of the CLI with 1 and ``n_proc`` processes, ``batch`` frames
    a process, from the processes' device stage totals."""
    def fps(n: int, tmp: str) -> float:
        outs = launch_cli(["-f", str(batch * n), "-s", resolution,
                           "--Synthetic", "--BatchFrames", str(batch),
                           "-l", f"{tmp}/p{n}_"], n, timeout=1800)
        busy_s = max(sum(float(ms) for _, ms in _STAGE.findall(out)) / 1e3
                     for out in outs)
        return batch * n / busy_s

    with tempfile.TemporaryDirectory() as tmp:
        fps1, fps_n = fps(1, tmp), fps(n_proc, tmp)
    return {"processes": n_proc, "fps_1proc": fps1, "fps_nproc": fps_n,
            "efficiency": fps_n / (fps1 * n_proc)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-s", "--resolution", default="1920x1080")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per iteration (per process)")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--devices", type=int, default=None,
                   help="devices of the mesh and latency runs (default: "
                        "every visible CUDA device)")
    p.add_argument("--latency", action="store_true",
                   help="one frame over N devices: class-sharded vs "
                        "space-banded time to result")
    p.add_argument("--processes", type=int, default=0,
                   help="the CLI over this many processes, against one")
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.resolution.lower().split("x"))
    out = {"resolution": args.resolution}
    if args.processes:
        devs, what = devices(None)
        out["devices"] = f"{args.processes} processes sharing {what}"
        out.update(processes_report(args.resolution, args.batch,
                                    args.processes))
    else:
        devs, what = devices(args.devices)
        out["devices"] = what
        out.update(latency_report(w, h, args.iters, devs) if args.latency
                   else mesh_report(w, h, args.batch, args.iters, devs))
    out["timing"] = ("CUDA events" if devs[0].type == "cuda"
                     else "host clock")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
