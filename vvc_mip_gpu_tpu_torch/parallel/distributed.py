"""Multi-process runtime: process group, global mesh, host-sharded frame
ingest and per-process decisions export.

The reference engine is single-process, single-GPU (main.cpp:217-228);
this is the build's own scaling axis (SURVEY.md §2.2, §5): N processes x M
local devices, frames data-parallel across processes (no cross-frame
communication at all), CTU-row bands spatial-parallel *within* a process
(the sharded engine's halo never leaves the process).

The processes talk through ``torch.distributed`` with the gloo backend on
host tensors, as a rule: the only traffic between them is an exchange of
device counts at start, the process all-gather of the target-CTU rows and
barriers, all small and on the host.  Usage (one process per host, or
several on one)::

    initialize(coordinator, num_processes, process_id)
    mesh = make_global_mesh(n_space, local_devices)   # data axis inferred
    runner = DistributedRunner(w, h, mesh)
    costs = runner.compute(local_frames, n_frames)    # this process's rows
    for poc, msh, sad, satd in runner.local_results(costs, n_frames): ...
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from vvc_mip_gpu_tpu_torch.models.cost_engine import as_frames
from vvc_mip_gpu_tpu_torch.parallel.mesh import make_mesh
from vvc_mip_gpu_tpu_torch.parallel.sharded_engine import ShardedMipCostEngine
from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing


def initialize(coordinator_address: str | None, num_processes: int,
               process_id: int) -> None:
    """Join the gloo process group at ``host:port`` (idempotent per
    process).  Process 0 serves the rendezvous at that address."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        raise ValueError("a multi-process run needs a coordinator address "
                         "host:port (--Coordinator)")
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_device_grid(local_devices) -> np.ndarray:
    """[n_processes, n_local_devices] device grid, rows = processes: row
    p names process p's devices (each process names its own the same way,
    ``cuda:0`` ...).  Requires every process to hold the same number of
    devices."""
    local = [torch.device(d) for d in local_devices]
    counts = [0] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"the processes hold {counts} devices; they must "
                         "hold the same number")
    grid = np.empty((len(counts), len(local)), dtype=object)
    for row in grid:
        row[:] = local
    return grid


def make_global_mesh(n_space: int, local_devices) -> np.ndarray:
    """(data, space) mesh over ALL processes' devices: the ``space`` axis
    (halo traffic) is laid out *within* a process, the ``data`` axis (no
    communication) spans processes.  Data row r belongs to process
    r // (n_data / n_processes).

    ``n_space`` must divide the per-process device count.
    """
    grid = process_device_grid(local_devices)
    n_proc, per = grid.shape
    if per % n_space:
        raise ValueError(
            f"space axis {n_space} must divide the {per} local devices")
    # [n_proc, per] -> [n_proc * per//n_space (data), n_space (space)]:
    # each process contributes per//n_space data rows of n_space devices.
    arr = grid.reshape(n_proc * (per // n_space), n_space)
    return make_mesh(arr.shape[0], arr.shape[1], devices=list(arr.ravel()))


class DistributedRunner:
    """Host-sharded MIP cost search: each process feeds, computes and
    reads back only its own frames, on its own rows of the global mesh."""

    def __init__(self, width: int, height: int, mesh: np.ndarray,
                 max_performance: bool = True):
        self.n_data = mesh.shape[0]
        self.n_proc = dist.get_world_size()
        if self.n_data % self.n_proc:
            raise ValueError("data axis must split evenly over processes")
        self.data_per_proc = self.n_data // self.n_proc
        rank = dist.get_rank()
        self.engine = ShardedMipCostEngine(
            width, height,
            mesh[rank * self.data_per_proc:(rank + 1) * self.data_per_proc],
            max_performance=max_performance)
        self._ring = ReadbackRing()

    def frame_slice(self, n_frames: int) -> range:
        """Global frame indices THIS process ingests/exports.

        The global batch is padded up to a multiple of the data axis; the
        padding frames land on the last process and are dropped on export.
        """
        batch = -(-n_frames // self.n_data) * self.n_data
        per = batch // self.n_proc
        p = dist.get_rank()
        return range(p * per, min((p + 1) * per, n_frames))

    def _local_batch(self, n_frames: int) -> int:
        return -(-n_frames // self.n_data) * self.n_data // self.n_proc

    def compute(self, local_frames, n_frames: int, local_refs=None):
        """``local_frames``: [len(frame_slice), H, W] — only this process's
        frames (numpy or a tensor).  Rows are padded up to the per-process
        batch (repeating the last frame; zeros for a process that owns no
        frame; padding results are never exported).  Returns the local
        engine's FrameCosts, [local batch, nCTU_padded, 97840]."""
        per = self._local_batch(n_frames)

        def _local(fr):
            fr = as_frames(fr)
            if fr.shape[0] == 0:
                return fr.new_zeros((per, *fr.shape[1:]))
            if fr.shape[0] == per:
                return fr
            return torch.cat([fr, fr[-1:].expand(per - fr.shape[0], -1, -1)])

        return self.engine(_local(local_frames),
                           None if local_refs is None else _local(local_refs))

    def local_results(self, costs, n_frames: int):
        """Yield (poc, msh, sad, satd) numpy rows [nCTU_padded, 97840] for
        THIS process's frames only — per-process export, no gather.  The
        rows alias the runner's readback ring (utils/readback.py): they
        stay valid until the next-but-one call."""
        sl = self.frame_slice(n_frames)
        msh, sad, satd = self._ring.read(*(
            None if t is None else t[:len(sl)]
            for t in (costs.min_sad_had, costs.sad, costs.satd)))
        for i, poc in enumerate(sl):
            yield (poc, msh[i],
                   None if sad is None else sad[i],
                   None if satd is None else satd[i])


def process_allgather(a: np.ndarray) -> np.ndarray:
    """Every process's ``a`` (same shape and type everywhere), stacked in
    process order: [n_processes, *a.shape], on every process."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def barrier() -> None:
    dist.barrier()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_LAUNCH_ATTEMPTS = 3  # runs of launch_cli when another program took the port


def launch_cli(cli_args: list[str], n_proc: int, *, timeout: float,
               env: dict[str, str] | None = None) -> list[str]:
    """Run the port's CLI (``python -m vvc_mip_gpu_tpu_torch.cli``) as
    ``n_proc`` processes on this host, joined through gloo on a free
    localhost port: process i gets ``cli_args`` plus ``--NumProcesses
    n_proc --Coordinator localhost:<port> --ProcessId i``.  ``env`` adds
    to this process's environment.  Returns each process's output
    (stdout and stderr).

    Raises RuntimeError, with the outputs, when a process exits non-zero
    or when ``timeout`` seconds pass first (every process is killed).  A
    run that failed only because another program took the port between
    choosing and binding it is retried on a new port, up to three runs in
    all."""
    root = Path(__file__).resolve().parents[2]  # holds the package
    child_env = {**os.environ, **(env or {})}
    for attempt in range(1, _LAUNCH_ATTEMPTS + 1):
        port = _free_port()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.ExitStack() as stack:
            logs = [stack.enter_context(open(Path(tmp) / f"p{i}.log", "w+"))
                    for i in range(n_proc)]
            procs = [subprocess.Popen(
                [sys.executable, "-m", "vvc_mip_gpu_tpu_torch.cli", *cli_args,
                 "--NumProcesses", str(n_proc), "--Coordinator",
                 f"localhost:{port}", "--ProcessId", str(i)],
                cwd=root, env=child_env, stdin=subprocess.DEVNULL,
                stdout=log, stderr=subprocess.STDOUT)
                for i, log in enumerate(logs)]
            deadline = time.monotonic() + timeout
            timed_out = False
            try:
                for p in procs:
                    p.wait(timeout=max(deadline - time.monotonic(), 0))
            except subprocess.TimeoutExpired:
                timed_out = True
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
        rcs = [p.returncode for p in procs]
        if not timed_out and all(rc == 0 for rc in rcs):
            return outs
        port_taken = any("Address already in use" in o for o in outs)
        if timed_out or not port_taken or attempt == _LAUNCH_ATTEMPTS:
            what = (f"timed out after {timeout} s" if timed_out
                    else f"exit codes {rcs}")
            tails = "\n".join(f"--- process {i} ---\n{o[-4000:]}"
                              for i, o in enumerate(outs))
            raise RuntimeError(f"CLI processes failed ({what}):\n{tails}")
