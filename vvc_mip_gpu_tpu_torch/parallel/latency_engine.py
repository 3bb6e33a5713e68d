"""Latency-mode engine: ONE frame across N devices by shape-class sharding.

The spatial (CTU-row band) engine pays intrinsic geometry costs in
latency mode: frame heights must pad to ``space * 128`` (a 1080p frame is
9 CTU rows — 8-way banding computes 16, a 1.78x blowup), plus a halo.
This engine shards the OTHER embarrassingly-parallel axis the cost search
exposes: the 17 CU shape classes are mutually independent given the
frame, and their per-group cost blocks concatenate into the strided layout
(reference: intra.cl dispatches each class as separate kernel enqueues
too, main.cpp:886-992 — but serially on one GPU).

Design: the frame is uploaded once to each distinct device; each part
runs only its class subset (``compute_blocks(..., classes=part)``, one
kernel launch per class) on its device and on a CUDA stream of its own, so
parts run concurrently even when they share a card.  No collective, no
halo, no geometry padding: the only imbalance is the static class
partition, bounded by max-class-weight / total (the 8x8 class, ~18% of
frame ops at 1080p).

Partition weights default to the analytic per-class element-op counts
(the op model: diff, SAD, butterflies and SATD per sample per mode, plus
the upsampling and the prediction epilogue); pass measured per-class
milliseconds via ``weights`` to repartition on profile data.
"""

from __future__ import annotations

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.constants import GROUPS, num_ctus, shape_classes
from vvc_mip_gpu_tpu_torch.models.cost_engine import (
    FrameCosts,
    _validity_mask,
    compute_blocks,
)
from vvc_mip_gpu_tpu_torch.parallel.mesh import (
    fork,
    join,
    on_stream,
    shard_stream,
    visible_devices,
)
from vvc_mip_gpu_tpu_torch.parallel.sharded_engine import as_frames


def class_weights(width: int, height: int) -> list[float]:
    """Analytic per-class element-op weights (the op model: diff + SAD +
    butterflies + SATD accumulate per sample per mode, plus the upsample
    interpolation and prediction epilogue)."""
    _, _, n_ctus = num_ctus(width, height)
    out = []
    for cl in shape_classes():
        h, w, r = cl.height, cl.width, cl.reduced_pred_size
        n_cu = cl.cus_per_ctu * n_ctus
        up = (4 * r * w if r < w else 0) + (4 * h * w if (r < h or r < w)
                                            else 0)
        ops_mode = 9 * h * w + up + 4 * r * r + 6
        out.append(float(n_cu * cl.total_modes * ops_mode))
    return out


def partition_classes(n_parts: int,
                      weights: list[float]) -> list[tuple[int, ...]]:
    """Greedy LPT partition of class indices into ``n_parts`` subsets;
    parts beyond the class count come back empty."""
    order = sorted(range(len(weights)), key=lambda i: -weights[i])
    loads = [0.0] * n_parts
    parts: list[list[int]] = [[] for _ in range(n_parts)]
    for i in order:
        j = int(np.argmin(loads))
        loads[j] += weights[i]
        parts[j].append(i)
    return [tuple(sorted(p)) for p in parts]


class LatencyMipCostEngine:
    """Single-frame, multi-device cost search (latency mode).

    >>> eng = LatencyMipCostEngine(1920, 1080)   # every visible CUDA card
    >>> costs = eng(frame)          # frame: [H, W]; costs on the host
    """

    def __init__(self, width: int, height: int, devices=None,
                 max_performance: bool = True,
                 weights: list[float] | None = None):
        """``devices``: one per part (default: every visible CUDA device);
        a device may repeat, and each part gets a stream of its own."""
        if width % 4 or height % 4:
            raise ValueError("frame dimensions must be multiples of 4")
        devices = [torch.device(d) for d in (
            devices if devices is not None else visible_devices())]
        if not devices:
            raise RuntimeError(
                "LatencyMipCostEngine: no CUDA device is available; pass "
                "devices=[torch.device('cpu')] to run the plain PyTorch path")
        self.width = width
        self.height = height
        self.max_performance = max_performance
        weights = weights if weights is not None else class_weights(
            width, height)
        parts = partition_classes(len(devices), weights)
        # (device, class subset, stream) of every part that has classes
        self._parts = [(dev, p, shard_stream(dev))
                       for dev, p in zip(devices, parts) if p]
        self._valid = torch.from_numpy(_validity_mask(width, height))

    def dispatch(self, frame, ref_frame=None) -> list:
        """Upload the frame (and reference) once per distinct device and
        enqueue every part's class subset on its stream; returns the raw
        per-part block dicts, still on the devices.  Pair with
        :meth:`assemble`; callers that want stage-accurate timing (e.g.
        the CLI's ENQUEUE/READ split) use the pair."""
        frame = as_frames(frame)
        ref_frame = None if ref_frame is None else as_frames(ref_frame)
        uploaded: dict[torch.device, tuple] = {}
        outs = []
        for dev, classes, stream in self._parts:
            if dev not in uploaded:
                fd = frame.to(dev)[None]
                uploaded[dev] = (fd, fd if ref_frame is None
                                 else ref_frame.to(dev)[None])
            fd, rd = uploaded[dev]  # rd is fd in the shared regime
            fork(stream, fd, rd)
            with on_stream(stream):
                sad, satd, msh = compute_blocks(
                    fd, rd, rd[:, 0], True, self.width, self.height,
                    max_performance=self.max_performance, classes=classes)
            outs.append((stream, (msh,) if self.max_performance
                         else (sad, satd)))
        return outs

    def gather(self, outs) -> list[torch.Tensor]:
        """The device step of :meth:`assemble`: the per-part blocks
        concatenated in the strided layout on the first part's device,
        ``[msh]`` in max-performance runs, else ``[sad, satd]``, each
        [nCTU, 97840]; the current stream waits for every part."""
        dev0 = self._parts[0][0]
        fields: list[dict[int, torch.Tensor]] = [{}, {}]
        for stream, blocks in outs:
            for k, bl in enumerate(blocks):
                join(stream, *bl.values())
                fields[k].update(bl)
        return [torch.cat([f[g.index].to(dev0) for g in GROUPS], -1)[0]
                for f in fields[:len(outs[0][1])]]

    def finish(self, host: list[torch.Tensor]) -> FrameCosts:
        """The host step of :meth:`assemble`: FrameCosts of the gathered
        fields read back to the host, minSadHad taken here in the full
        report."""
        if self.max_performance:
            sad = satd = None
            (msh,) = host
        else:
            sad, satd = host
            msh = torch.minimum(2 * sad, satd)
        return FrameCosts(sad=sad, satd=satd, min_sad_had=msh,
                          valid=self._valid)

    def assemble(self, outs) -> FrameCosts:
        """Concatenate the per-part blocks in the strided layout on the
        first part's device, read them back (blocks until every part
        finishes), and in the full report take minSadHad on the host.
        FrameCosts fields are new host tensors, [nCTU, 97840]."""
        return self.finish([t.cpu() for t in self.gather(outs)])

    def __call__(self, frame, ref_frame=None) -> FrameCosts:
        return self.assemble(self.dispatch(frame, ref_frame))
