"""Command-line interface — the analog of the reference `main` binary.

Flag names follow the reference CLI (reference: main.cpp:50-69, README.md:
28-50) and the JAX package's CLI:

    python -m vvc_mip_gpu_tpu_torch.cli -f 2 -s 1920x1080 -o frames.csv -l out_
        [--FilterType filterFrame_2d_int_quarterCtu --KernelIdx 2]
        [--OnlyFilter] [--FullDistortion] [--TargetCTU 5] [--TracePower]
        [--BatchFrames 8] [--Resume] [--DeviceIndex 0] [--Synthetic]

Pipeline (reference: main.cpp:678-1241): read frames -> optional low-pass
filter (the filtered frames stay on the device) -> MIP cost search in
chunks of --BatchFrames frames -> decisions CSV export per frame, on a
writer thread while the next chunk is searched.  Runs on
the CUDA device ``cuda:<DeviceIndex>``; with VVC_MIP_PLATFORM=cpu in the
environment it runs on the CPU instead (the kernels' plain versions).
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
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.models.inspect import report_target_ctu
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
from vvc_mip_gpu_tpu_torch.utils.config import EngineConfig
from vvc_mip_gpu_tpu_torch.utils.pipeline import pipelined
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
                   help="Data-parallel (frame) mesh axis size (not ported "
                        "yet: must be 1)")
    p.add_argument("--MeshSpace", type=int, default=1,
                   help="Spatial (CTU-row) mesh axis size (not ported "
                        "yet: must be 1)")
    p.add_argument("--Coordinator", type=str, default=None,
                   help="Multi-host coordinator address (not ported yet)")
    p.add_argument("--NumProcesses", type=int, default=1,
                   help="Multi-host: total number of processes (not "
                        "ported yet: must be 1)")
    p.add_argument("--ProcessId", type=int, default=0,
                   help="Multi-host: this process's index (not ported "
                        "yet: must be 0)")
    p.add_argument("--TargetCTU", type=int, default=None,
                   help="Print the distortion table of this CTU and write "
                        "a multi-frame POC-columned CSV for it "
                        "(reference reportDistortionOnlyTarget / "
                        "reportTargetDistortionValues_File)")
    p.add_argument("--LatencyMode", action="store_true",
                   help="Class-sharded single-frame latency mode (not "
                        "ported yet)")
    p.add_argument("--BatchFrames", type=int, default=8,
                   help="Frames per device dispatch (the analog of the "
                        "reference's BUFFER_SLOTS pipelining): one chunk's "
                        "CSVs are written while the next is searched, so "
                        "the costs of two chunks are held in host memory")
    p.add_argument("--Resume", action="store_true",
                   help="Skip frames whose decisions CSV already exists "
                        "(checkpoint/resume for long multi-frame runs)")
    p.add_argument("--DeviceIndex", type=int, default=0,
                   help="CUDA device to run on (cuda:<DeviceIndex>)")
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


def run_device(cfg: EngineConfig) -> torch.device:
    """``cuda:<device_index>``, or the CPU when the environment sets
    VVC_MIP_PLATFORM=cpu.  Raises when no CUDA device is available."""
    platform = os.environ.get(PLATFORM_ENV, "")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda"):
        raise ValueError(f"{PLATFORM_ENV}={platform!r}: want 'cpu' or "
                         f"'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available; set "
                           f"{PLATFORM_ENV}=cpu to run on the CPU")
    if not 0 <= cfg.device_index < torch.cuda.device_count():
        raise ValueError(f"--DeviceIndex {cfg.device_index}: the machine "
                         f"has {torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", cfg.device_index)


def run(cfg: EngineConfig, synthetic: bool = False,
        target_ctu: int | None = None, resume: bool = False) -> int:
    device = run_device(cfg)
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

    engine = MipCostEngine(cfg.width, cfg.height,
                           max_performance=cfg.max_performance,
                           device=device)
    chunk_n = max(1, cfg.batch_frames)

    def dispatch(pocs):
        """The chunk's search and readback, on this thread."""
        idx = torch.tensor(pocs, device=device)
        with timer.stage("ENQUEUE KERNELS"):
            costs = engine.compute_batch(
                frames.index_select(0, idx),
                None if ref_frames is None
                else ref_frames.index_select(0, idx))
        with timer.stage("READ DISTORTION"):
            return tuple(None if t is None else t.cpu().numpy()
                         for t in (costs.min_sad_had, costs.sad, costs.satd))

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
                    tgt_msh[f] = msh[b, target_ctu]
                    tgt_sad[f] = None if sad_b is None else sad_b[target_ctu]
                    tgt_satd[f] = (None if satd_b is None
                                   else satd_b[target_ctu])
                    report_target_ctu(msh[b], cfg.width, target_ctu,
                                      sad=sad_b, satd=satd_b)

    pending = [f for f in range(cfg.n_frames)
               if not (resume and os.path.exists(_out_path(cfg, f)))]
    for f in range(cfg.n_frames):
        if f not in pending:
            print(f"skipping frame {f} (exists: {_out_path(cfg, f)})")
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
