"""Command-line interface — the analog of the reference `main` binary.

Flag names follow the reference CLI (reference: main.cpp:50-69, README.md:
28-50) and the JAX package's CLI:

    python -m vvc_mip_gpu_tpu_torch.cli -f 2 -s 1920x1080 -o frames.csv -l out_
        [--FilterType filterFrame_2d_int_quarterCtu --KernelIdx 2]
        [--OnlyFilter] [--FullDistortion] [--TargetCTU 5] [--TracePower]
        [--BatchFrames 8] [--Resume] [--DeviceIndex 0] [--Synthetic]
        [--MeshData 1 --MeshSpace 1] [--LatencyMode]
        [--NumProcesses 2 --Coordinator host:port --ProcessId 0]

Pipeline (reference: main.cpp:678-1241): read frames -> optional low-pass
filter (the filtered frames stay on the device) -> MIP cost search in
chunks of --BatchFrames frames -> decisions CSV export per frame, on a
writer thread while the next chunk is searched.  Runs on the CUDA device
``cuda:<DeviceIndex>``; a mesh (--MeshData x --MeshSpace, the sharded
engine) or --LatencyMode (the class-sharded engine) runs on every visible
CUDA device (a mesh's shards on streams of the one card when there is
one), and --NumProcesses > 1 runs one process per host (gloo).
With VVC_MIP_PLATFORM=cpu in the environment it runs on the CPU instead
(the kernels' plain versions), the CPU standing in for as many devices as
a mesh asks for.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.constants import num_ctus
from vvc_mip_gpu_tpu_torch.io import export
from vvc_mip_gpu_tpu_torch.io import frames as fio
from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, MipCostEngine
from vvc_mip_gpu_tpu_torch.models.inspect import report_target_ctu
from vvc_mip_gpu_tpu_torch.ops._build import build_libraries
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
from vvc_mip_gpu_tpu_torch.parallel import distributed as dist
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine
from vvc_mip_gpu_tpu_torch.parallel.mesh import make_mesh, visible_devices
from vvc_mip_gpu_tpu_torch.parallel.sharded_engine import ShardedMipCostEngine
from vvc_mip_gpu_tpu_torch.utils.config import EngineConfig
from vvc_mip_gpu_tpu_torch.utils.pipeline import pipelined
from vvc_mip_gpu_tpu_torch.utils.readback import (PartedRead, ReadbackRing,
                                                  part_plan)
from vvc_mip_gpu_tpu_torch.utils.timing import StageTimer, print_timestamp

PLATFORM_ENV = "VVC_MIP_PLATFORM"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vvc-mip-gpu",
        description="VVC MIP mode-search cost engine on a CUDA device")
    p.add_argument("--FramesToBeEncoded", "-f", type=int, default=1,
                   help="Number of frames to be processed")
    p.add_argument("--Resolution", "-s", type=str, required=True,
                   help="Video resolution, e.g. 1920x1080")
    p.add_argument("--OriginalFrames", "-o", type=str, default=None,
                   help="Input CSV of original frame samples")
    p.add_argument("--OutputPreffix", "-l", type=str, default="",
                   help="Output file prefix for the decisions log")
    p.add_argument("--FilterType", type=str, default=None,
                   help="Smoothing filter for alternative reference samples")
    p.add_argument("--KernelIdx", type=int, default=0,
                   help="Filter coefficient set index")
    p.add_argument("--OnlyFilter", action="store_true",
                   help="Filter the frames, export them, and exit "
                        "(reference ONLY_FILTER_AND_EXIT)")
    p.add_argument("--FullDistortion", action="store_true",
                   help="Export SAD/SATD columns too (disables the "
                        "reference's MAX_PERFORMANCE_DIST fast path)")
    p.add_argument("--TracePower", action="store_true",
                   help="Print stage timestamps for the energy harness")
    p.add_argument("--Synthetic", action="store_true",
                   help="Use deterministic synthetic frames (no input file)")
    p.add_argument("--MeshData", type=int, default=1,
                   help="Data-parallel (frame) mesh axis size")
    p.add_argument("--MeshSpace", type=int, default=1,
                   help="Spatial (CTU-row) mesh axis size")
    p.add_argument("--Coordinator", type=str, default=None,
                   help="Multi-host: coordinator address host:port "
                        "(torch.distributed, gloo); one process per host")
    p.add_argument("--NumProcesses", type=int, default=1,
                   help="Multi-host: total number of processes")
    p.add_argument("--ProcessId", type=int, default=0,
                   help="Multi-host: this process's index")
    p.add_argument("--TargetCTU", type=int, default=None,
                   help="Print the distortion table of this CTU and write "
                        "a multi-frame POC-columned CSV for it "
                        "(reference reportDistortionOnlyTarget / "
                        "reportTargetDistortionValues_File)")
    p.add_argument("--LatencyMode", action="store_true",
                   help="Minimize per-frame latency: each frame is "
                        "class-sharded across ALL local devices "
                        "(no banding/padding)")
    p.add_argument("--BatchFrames", type=int, default=8,
                   help="Frames per device dispatch (the analog of the "
                        "reference's BUFFER_SLOTS pipelining): one chunk's "
                        "CSVs are written while the next is searched, so "
                        "the costs of two chunks are held in host memory")
    p.add_argument("--Resume", action="store_true",
                   help="Skip frames whose decisions CSV already exists "
                        "(checkpoint/resume for long multi-frame runs)")
    p.add_argument("--DeviceIndex", type=int, default=0,
                   help="CUDA device to run on (cuda:<DeviceIndex>); the "
                        "mesh, latency and multi-host paths use every "
                        "visible device")
    return p


def _config_from_args(args) -> EngineConfig:
    w, h = EngineConfig.parse_resolution(args.Resolution)
    cfg = EngineConfig(
        width=w, height=h,
        n_frames=args.FramesToBeEncoded,
        input_path=args.OriginalFrames,
        output_prefix=args.OutputPreffix,
        filter_type=args.FilterType,
        kernel_idx=args.KernelIdx,
        only_filter=args.OnlyFilter,
        max_performance=not args.FullDistortion,
        trace_power=args.TracePower,
        batch_frames=args.BatchFrames,
        device_index=args.DeviceIndex,
        mesh_data=args.MeshData,
        mesh_space=args.MeshSpace,
        latency_mode=args.LatencyMode,
        coordinator=args.Coordinator,
        num_processes=args.NumProcesses,
        process_id=args.ProcessId,
    )
    cfg.validate()
    return cfg


def _platform() -> str:
    """"cpu" when the environment sets VVC_MIP_PLATFORM=cpu, else "cuda";
    raises when no CUDA device is available."""
    platform = os.environ.get(PLATFORM_ENV, "")
    if platform == "cpu":
        return platform
    if platform not in ("", "cuda"):
        raise ValueError(f"{PLATFORM_ENV}={platform!r}: want 'cpu' or "
                         f"'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available; set "
                           f"{PLATFORM_ENV}=cpu to run on the CPU")
    return "cuda"


def run_device(cfg: EngineConfig) -> torch.device:
    """``cuda:<device_index>``, or the CPU when the environment sets
    VVC_MIP_PLATFORM=cpu.  Raises when no CUDA device is available."""
    if _platform() == "cpu":
        return torch.device("cpu")
    if not 0 <= cfg.device_index < torch.cuda.device_count():
        raise ValueError(f"--DeviceIndex {cfg.device_index}: the machine "
                         f"has {torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", cfg.device_index)


def local_devices(n_cpu: int) -> list[torch.device]:
    """The devices of a multi-device path: every visible CUDA device, or,
    with VVC_MIP_PLATFORM=cpu, the CPU ``n_cpu`` times (the counterpart of
    the JAX test rig's forced host devices).  Raises when no CUDA device
    is available."""
    if _platform() == "cpu":
        return [torch.device("cpu")] * n_cpu
    return visible_devices()


def mesh_devices(n: int) -> list[torch.device]:
    """The devices of an ``n``-device mesh: ``local_devices(n)``, with one
    card alone standing in for all ``n`` (its shards run as streams on it,
    as in tools/scaling_report.py)."""
    devices = local_devices(n)
    return devices * n if len(devices) == 1 else devices


def _searcher(cfg: EngineConfig, device: torch.device, n_pending: int):
    """(chunk size, enqueue, read) of the single-process engine the flags
    select: ``enqueue(frames, refs, pocs)`` starts the search of a chunk
    and ``read(pending, n)`` returns its (msh, sad, satd) host arrays,
    [n, nCTU, 97840] each (sad, satd None in max-performance runs).  The
    arrays alias a readback ring's buffers (utils/readback.py): valid
    until the next-but-one read, which is as long as the pipeline's
    drain of the chunk needs them.

    On one CUDA device (neither a mesh nor --LatencyMode) ``enqueue``
    searches the chunk in parts of whole frames (``readback.part_plan``)
    on the device's current stream, and after each part's launches hands
    the part to the ring, whose copy stream copies it to the pinned slot
    while the next part searches; ``read`` waits for the copy stream.  So
    only the last part's copy stands after the search.  On the CPU, and
    for a chunk too small for two parts, ``enqueue`` searches the chunk
    in one pass and ``read`` copies it with ``ReadbackRing.read``: on the
    CPU a copy runs on the calling thread, so nothing could overlap it.
    In --LatencyMode on one CUDA card ``enqueue`` hands the ring to the
    latency engine's ``dispatch``, which copies each SizeId's block of
    columns to the pinned slot while the next SizeId searches
    (``LatencyMipCostEngine.dispatch``); ``read`` returns the slot's
    arrays."""
    true_n = num_ctus(cfg.width, cfg.height)[2]
    ring = ReadbackRing()

    def host(costs, n):
        # the true frames and the true CTU count: a mesh pads the batch
        # to its data axis and the height to whole bands of CTU rows
        return ring.read(*(None if t is None else t[:n, :true_n]
                           for t in (costs.min_sad_had, costs.sad,
                                     costs.satd)))

    if cfg.latency_mode:
        engine = LatencyMipCostEngine(cfg.width, cfg.height, local_devices(1),
                                      max_performance=cfg.max_performance)

        def enqueue(frames, refs, pocs):  # one frame a chunk
            return engine.dispatch(frames[pocs[0]],
                                   None if refs is None else refs[pocs[0]],
                                   ring)

        def read(outs, n):
            costs = engine.assemble(outs, ring.read)
            return tuple(None if t is None else t[None].numpy()
                         for t in (costs.min_sad_had, costs.sad, costs.satd))

        return 1, enqueue, read
    if cfg.mesh_data * cfg.mesh_space > 1:
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_space,
                         mesh_devices(cfg.mesh_data * cfg.mesh_space))
        engine = ShardedMipCostEngine(cfg.width, cfg.height, mesh,
                                      max_performance=cfg.max_performance)
        # --BatchFrames rounded up to a multiple of the data axis
        chunk_n = -(-max(cfg.batch_frames, 1) // cfg.mesh_data) * cfg.mesh_data

        def enqueue(frames, refs, pocs):
            # Pad the chunk up to a multiple of the data axis (to chunk_n
            # when there are several chunks) by repeating the last poc;
            # the padding's costs are dropped on read.
            target = (chunk_n if n_pending > chunk_n
                      else -(-len(pocs) // cfg.mesh_data) * cfg.mesh_data)
            idx = torch.tensor(list(pocs) + [pocs[-1]] * (target - len(pocs)),
                               device=frames.device)
            return engine(frames.index_select(0, idx),
                          None if refs is None else refs.index_select(0, idx))

        return chunk_n, enqueue, host
    engine = MipCostEngine(cfg.width, cfg.height,
                           max_performance=cfg.max_performance, device=device)

    def enqueue(frames, refs, pocs):
        idx = torch.tensor(pocs, device=device)
        frames = frames.index_select(0, idx)
        refs = None if refs is None else refs.index_select(0, idx)
        parts = part_plan(device.type, len(pocs), true_n)
        if len(parts) == 1:
            return engine.compute_batch(frames, refs)
        pending = ring.parted(len(pocs))
        for b0, b1 in parts:
            costs = engine.compute_batch(
                frames[b0:b1], None if refs is None else refs[b0:b1])
            pending.copy(b0, costs.min_sad_had, costs.sad, costs.satd)
        return pending

    def read(pending, n):
        if isinstance(pending, PartedRead):
            return pending.read()
        return host(pending, n)

    return max(1, cfg.batch_frames), enqueue, read


def run(cfg: EngineConfig, synthetic: bool = False,
        target_ctu: int | None = None, resume: bool = False) -> int:
    if cfg.num_processes > 1:
        return _run_distributed(cfg, synthetic=synthetic, resume=resume,
                                target_ctu=target_ctu)
    # the device that holds the frames: the first shard's or part's
    multi = cfg.latency_mode or cfg.mesh_data * cfg.mesh_space > 1
    device = local_devices(1)[0] if multi else run_device(cfg)
    n_ctu = num_ctus(cfg.width, cfg.height)[2]
    if target_ctu is not None and not 0 <= target_ctu < n_ctu:
        raise ValueError(f"--TargetCTU {target_ctu} out of range "
                         f"(0..{n_ctu - 1})")
    timer = StageTimer(trace_power=cfg.trace_power, device=device)
    if cfg.trace_power:
        print_timestamp("STARTED HOST")

    with timer.stage("READ SAMPLES"):
        if synthetic or cfg.input_path is None:
            frames = fio.synthetic_frames(cfg.n_frames, cfg.width, cfg.height)
        else:
            frames = fio.read_frames_csv(
                cfg.input_path, cfg.width, cfg.height, cfg.n_frames)
        frames = torch.from_numpy(frames.astype(np.int32)).to(device)

    ref_frames = None
    if cfg.filter_type is not None:
        with timer.stage("ENQUEUE FILTER"):
            # The filtered frames stay on the device and feed the engine
            # directly (the reference round-trips them through the host
            # only for export, main.cpp:793-822).
            ref_frames = filter_frames(frames, cfg.filter_type,
                                       cfg.kernel_idx)
        if cfg.only_filter:
            out = f"{cfg.output_prefix}filtered.csv"
            fio.write_frames_csv(out, ref_frames.cpu().numpy())
            print(f"wrote {out}")
            print(timer.report_compact(cfg.n_frames))
            return 0

    # Multi-frame target-CTU accumulation (one POC-columned CSV at the
    # end; reference reportTargetDistortionValues_File,
    # main_aux_functions.h:843-906).
    tgt_msh: dict[int, np.ndarray] = {}
    tgt_sad: dict[int, np.ndarray | None] = {}
    tgt_satd: dict[int, np.ndarray | None] = {}

    pending = [f for f in range(cfg.n_frames)
               if not (resume and os.path.exists(_out_path(cfg, f)))]
    for f in range(cfg.n_frames):
        if f not in pending:
            print(f"skipping frame {f} (exists: {_out_path(cfg, f)})")
    chunk_n, enqueue, read = _searcher(cfg, device, len(pending))

    def dispatch(pocs):
        """The chunk's search and readback, on this thread."""
        with timer.stage("ENQUEUE KERNELS"):
            costs = enqueue(frames, ref_frames, pocs)
        with timer.stage("READ DISTORTION"):
            return read(costs, len(pocs))

    def drain(pocs, host_costs):
        """The chunk's CSVs and reports, on the writer thread while the
        next chunk is dispatched."""
        msh, sad, satd = host_costs
        with timer.stage("WRITE DECISIONS", sync=False):
            for b, f in enumerate(pocs):
                sad_b = None if sad is None else sad[b]
                satd_b = None if satd is None else satd[b]
                _export_frame(cfg, msh[b], sad_b, satd_b, poc=f)
                if target_ctu is not None:
                    # copies: the chunk's arrays alias the readback ring
                    tgt_msh[f] = msh[b, target_ctu].copy()
                    tgt_sad[f] = (None if sad_b is None
                                  else sad_b[target_ctu].copy())
                    tgt_satd[f] = (None if satd_b is None
                                   else satd_b[target_ctu].copy())
                    report_target_ctu(msh[b], cfg.width, target_ctu,
                                      sad=sad_b, satd=satd_b)

    pipelined((pending[c0:c0 + chunk_n]
               for c0 in range(0, len(pending), chunk_n)), dispatch, drain)

    if target_ctu is not None and tgt_msh:
        pocs = sorted(tgt_msh)
        tpath = f"{cfg.output_prefix}target_ctu{target_ctu}.csv"
        export.export_target_ctu_csv(
            tpath, [tgt_msh[f] for f in pocs], cfg.width, target_ctu,
            sad_per_frame=[tgt_sad[f] for f in pocs],
            satd_per_frame=[tgt_satd[f] for f in pocs], pocs=pocs)
        print(f"wrote {tpath}")

    print(timer.report())
    print(timer.report_compact(cfg.n_frames))
    return 0


def _run_distributed(cfg: EngineConfig, synthetic: bool, resume: bool,
                     target_ctu: int | None = None) -> int:
    """Multi-host path: join the gloo process group, build the global mesh
    (the space axis within a process), host-sharded ingest (each process
    reads only its own frame range), a local search of this process's
    frames, per-host decisions export, and a process all-gather of the
    target-CTU rows, which process 0 writes.

    The reference has no multi-device story at all (main.cpp:217-228);
    this is the build's declared scaling axis (SURVEY §2.2/§5).
    """
    n_ctu = num_ctus(cfg.width, cfg.height)[2]
    if target_ctu is not None and not 0 <= target_ctu < n_ctu:
        raise ValueError(f"--TargetCTU {target_ctu} out of range "
                         f"(0..{n_ctu - 1})")
    devices = mesh_devices(cfg.mesh_space)
    dist.initialize(cfg.coordinator, cfg.num_processes, cfg.process_id)
    try:
        if devices[0].type == "cuda":
            # Process 0 builds the kernel libraries; the others wait and
            # load them, rather than each running nvcc on a cold checkout.
            if cfg.process_id == 0:
                build_libraries()
            dist.barrier()
        timer = StageTimer(trace_power=cfg.trace_power, device=devices[0])
        mesh = dist.make_global_mesh(cfg.mesh_space, devices)
        runner = dist.DistributedRunner(cfg.width, cfg.height, mesh,
                                        max_performance=cfg.max_performance)
        sl = runner.frame_slice(cfg.n_frames)
        with timer.stage("READ SAMPLES"):
            if synthetic or cfg.input_path is None:
                local = fio.synthetic_frames(
                    cfg.n_frames, cfg.width, cfg.height)[list(sl)]
            else:
                local = fio.read_frames_csv(cfg.input_path, cfg.width,
                                            cfg.height, len(sl),
                                            start=sl.start)
            local = torch.from_numpy(local.astype(np.int32)).to(devices[0])
        refs = None
        if cfg.filter_type is not None:
            with timer.stage("ENQUEUE FILTER"):
                refs = filter_frames(local, cfg.filter_type, cfg.kernel_idx)
        with timer.stage("ENQUEUE KERNELS"):
            costs = runner.compute(local, cfg.n_frames, refs)
        with timer.stage("READ DISTORTION"):
            results = list(runner.local_results(costs, cfg.n_frames))
        tgt = []
        with timer.stage("WRITE DECISIONS", sync=False):
            for poc, msh, sad, satd in results:
                msh, sad, satd = (None if t is None else t[:n_ctu]
                                  for t in (msh, sad, satd))
                if target_ctu is not None:
                    report_target_ctu(msh, cfg.width, target_ctu, sad=sad,
                                      satd=satd)
                    tgt.append((poc, msh[target_ctu],
                                None if sad is None else sad[target_ctu],
                                None if satd is None else satd[target_ctu]))
                if resume and os.path.exists(_out_path(cfg, poc)):
                    print(f"skipping frame {poc} (exists)")
                    continue
                _export_frame(cfg, msh, sad, satd, poc=poc)
        if target_ctu is not None:
            _gather_target_ctu(cfg, runner, tgt, target_ctu)
        print(f"[process {cfg.process_id}] exported {len(results)} frames")
        print(timer.report())
        print(timer.report_compact(max(len(results), 1)))
        dist.barrier()  # no process leaves while a peer still needs it
    finally:
        dist.shutdown()
    return 0


def _gather_target_ctu(cfg: EngineConfig, runner, tgt,
                       target_ctu: int) -> None:
    """Multi-host --TargetCTU: every host owns only its own frames' cost
    rows, so the POC-columned target CSV (reference
    reportTargetDistortionValues_File, main_aux_functions.h:843-906) needs
    a cross-host gather.  The target rows are tiny (~32k values/frame);
    all-gather them padded to equal per-host shapes, then process 0 writes
    the CSV.  ALL hosts must reach this collective (consistent control
    flow), hence it runs unconditionally when --TargetCTU is set.
    """
    d = PER_CTU
    per = runner._local_batch(cfg.n_frames)
    full = not cfg.max_performance
    pocs_arr = np.full(per, -1, np.int32)
    rows = np.zeros((3 if full else 1, per, d), np.int64)  # msh, sad, satd
    for i, (poc, *costs) in enumerate(tgt):
        pocs_arr[i] = poc
        for k in range(len(rows)):
            rows[k, i] = costs[k]
    g_pocs = dist.process_allgather(pocs_arr).reshape(-1)
    g_rows = dist.process_allgather(rows).transpose(1, 0, 2, 3).reshape(
        len(rows), -1, d)
    if cfg.process_id != 0:
        return
    order = [int(i) for i in np.argsort(g_pocs, kind="stable")
             if g_pocs[i] >= 0]
    tpath = f"{cfg.output_prefix}target_ctu{target_ctu}.csv"
    export.export_target_ctu_csv(
        tpath, [g_rows[0, i] for i in order], cfg.width, target_ctu,
        sad_per_frame=[g_rows[1, i] if full else None for i in order],
        satd_per_frame=[g_rows[2, i] if full else None for i in order],
        pocs=[int(g_pocs[i]) for i in order])
    print(f"wrote {tpath}")


def _out_path(cfg, poc) -> str:
    suffix = f"_poc{poc}" if cfg.n_frames > 1 else ""
    return f"{cfg.output_prefix}mip_decisions{suffix}.csv"


def _export_frame(cfg, msh, sad, satd, poc):
    out = _out_path(cfg, poc)
    export.export_decisions_csv(
        out, msh, cfg.width, sad=sad, satd=satd,
        poc=poc if cfg.n_frames > 1 else None)
    print(f"wrote {out}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = _config_from_args(args)
    return run(cfg, synthetic=args.Synthetic, target_ctu=args.TargetCTU,
               resume=args.Resume)


if __name__ == "__main__":
    sys.exit(main())
