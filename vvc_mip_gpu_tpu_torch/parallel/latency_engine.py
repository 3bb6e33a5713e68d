"""Latency-mode engine: ONE frame across N devices by shape-class sharding.

The spatial (CTU-row band) engine pays intrinsic geometry costs in
latency mode: frame heights must pad to ``space * 128`` (a 1080p frame is
9 CTU rows — 8-way banding computes 16, a 1.78x blowup), plus a halo.
This engine shards the OTHER embarrassingly-parallel axis the cost search
exposes: the 17 CU shape classes are mutually independent given the
frame, and each writes its own columns of the strided layout (reference:
intra.cl dispatches each class as separate kernel enqueues too,
main.cpp:886-992 — but serially on one GPU).

Design: the frame is uploaded once to each distinct device; each part
runs only its class subset (``cost_engine._run_classes(...,
classes=part)``, one kernel launch per class) on its device and on a CUDA
stream of its own, so parts run concurrently even when they share a card.
The first part's output becomes the frame's: every further part's columns
(``cost_engine._columns``) are copied into it, and with one part nothing
is copied.  No collective, no halo, no geometry padding: the only
imbalance is the static class partition, bounded by max-class-weight /
total (the 8x8 class, ~18% of frame ops at 1080p).

The partition weighs the classes by their analytic element-op counts
(the op model: diff, SAD, butterflies and SATD per sample per mode, plus
the upsampling and the prediction epilogue).

With one part on a CUDA card and a readback ring to read into, the frame's
52.8 MB (1080p) need not wait for the last class: ``dispatch`` searches
the classes SizeId by SizeId (``size_parts``: each SizeId writes one
contiguous block of columns), and hands each block to the ring's copy
stream as soon as its launches are enqueued, so the link carries one block
while the next SizeId searches.  SizeId 0 goes first: the 4x4 class is a
third of the bytes and a twentieth of the search.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.constants import num_ctus, shape_classes
from vvc_mip_gpu_tpu_torch.models import cost_engine
from vvc_mip_gpu_tpu_torch.models.cost_engine import (
    PER_CTU,
    FrameCosts,
    _columns,
    _validity_mask,
    as_frames,
)
from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans
from vvc_mip_gpu_tpu_torch.parallel.mesh import (
    fork,
    join,
    on_stream,
    shard_stream,
    visible_devices,
)
from vvc_mip_gpu_tpu_torch.utils.readback import PartedRead, ReadbackRing
from vvc_mip_gpu_tpu_torch.utils.timing import span


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


def size_parts(width: int,
               height: int) -> list[tuple[tuple[int, ...], slice]]:
    """The classes of each SizeId (indices into ``class_plans``), SizeId 0
    first, each with the one block of columns of the strided layout that
    their groups write.  Raises where a SizeId's columns are not one
    contiguous block."""
    plans = class_plans(width, height)
    out = []
    for size_id in sorted({p.shape.size_id for p in plans}):
        classes = tuple(i for i, p in enumerate(plans)
                        if p.shape.size_id == size_id)
        cols = sorted(_columns(width, height, classes),
                      key=lambda c: c.start)
        if any(a.stop != b.start for a, b in zip(cols, cols[1:])):
            raise ValueError(f"SizeId {size_id}'s columns are not one block")
        out.append((classes, slice(cols[0].start, cols[-1].stop)))
    return out


class PartedFrame(NamedTuple):
    """What ``dispatch`` returns where the frame's costs go to a readback
    ring SizeId by SizeId: the part's stream, and the read its copies
    fill."""

    stream: torch.cuda.Stream
    read: PartedRead


class LatencyMipCostEngine:
    """Single-frame, multi-device cost search (latency mode).

    >>> eng = LatencyMipCostEngine(1920, 1080)   # every visible CUDA card
    >>> costs = eng(frame)          # frame: [H, W]; costs on the host
    """

    def __init__(self, width: int, height: int, devices=None,
                 max_performance: bool = True):
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
        parts = partition_classes(len(devices), class_weights(width, height))
        # (device, class subset, stream, its columns) of every part that has
        # classes
        self._parts = [(dev, p, shard_stream(dev), _columns(width, height, p))
                       for dev, p in zip(devices, parts) if p]
        # one part on a CUDA card: its search can run SizeId by SizeId,
        # each block read back while the next searches
        self._size_parts = (
            size_parts(width, height) if len(self._parts) == 1
            and self._parts[0][0].type == "cuda" else None)
        self._valid = torch.from_numpy(_validity_mask(width, height))

    def dispatch(self, frame, ref_frame=None,
                 ring: ReadbackRing | None = None):
        """Upload the frame (and reference) once per distinct device and
        enqueue every part's class subset on its stream; returns each
        part's (stream, outputs): ``_run_classes``' ``[msh]`` or ``[sad,
        satd]``, each [1, nCTU, 97840], still on the devices.  Pair with
        :meth:`assemble`; callers that want stage-accurate timing (e.g.
        the CLI's ENQUEUE/READ split) use the pair.  With ``ring`` and one
        part on a CUDA card, the part searches SizeId by SizeId and each
        block of columns is copied into a read of ``ring`` while the next
        SizeId searches; a ``PartedFrame`` comes back.  Spans
        ``latency.dispatch``, ``latency.upload`` for each device's copies,
        and ``readback.part`` for each block's copy."""
        with span("latency.dispatch"):
            frame = as_frames(frame)
            ref_frame = None if ref_frame is None else as_frames(ref_frame)
            uploaded: dict[torch.device, tuple] = {}
            outs = []
            for dev, classes, stream, _ in self._parts:
                if dev not in uploaded:
                    with span("latency.upload"):
                        fd = frame.to(dev)[None]
                        uploaded[dev] = (fd, fd if ref_frame is None
                                         else ref_frame.to(dev)[None])
                fd, rd = uploaded[dev]  # rd is fd in the shared regime
                fork(stream, fd, rd)
                with on_stream(stream):
                    if ring is not None and self._size_parts is not None:
                        # the engine's one part
                        return PartedFrame(stream, self._search_in_parts(
                            fd, rd, ring.parted(PER_CTU)))
                    fields = cost_engine._run_classes(
                        fd, rd, rd[:, 0], True, self.width, self.height,
                        self.max_performance, classes)
                outs.append((stream, fields))
            return outs

    def _search_in_parts(self, fd, rd, pending: PartedRead) -> PartedRead:
        """Every class, SizeId by SizeId on the current stream, each
        SizeId's block of columns handed to ``pending`` once its launches
        are enqueued: ``[msh]``, or ``[sad, satd, msh]`` with minSadHad
        formed over the block (``cost_engine._combine``)."""
        share_ref = rd is fd
        fd = cost_engine._as_samples(fd)  # cast once, not once a SizeId
        rd = fd if share_ref else cost_engine._as_samples(rd)
        for classes, cols in self._size_parts:
            fields = [t[..., cols] for t in cost_engine._run_classes(
                fd, rd, rd[:, 0], True, self.width, self.height,
                self.max_performance, classes)]
            if not self.max_performance:
                fields.append(cost_engine._combine(*fields))
            pending.copy_columns(cols.start, *fields)
        return pending

    def gather(self, outs) -> list[torch.Tensor]:
        """The device step of :meth:`assemble`: the first part's outputs
        with every further part's columns copied in, on the first part's
        device, ``[msh]`` in max-performance runs, else ``[sad, satd,
        msh]`` with minSadHad formed there (``cost_engine._combine``),
        each [nCTU, 97840]; the current stream waits for every part.
        Span ``latency.gather``."""
        with span("latency.gather"):
            for stream, fields in outs:
                join(stream, *fields)
            first = outs[0][1]
            for (_, _, _, columns), (_, fields) in zip(self._parts[1:],
                                                       outs[1:]):
                for dst, src in zip(first, fields):
                    for c in columns:
                        dst[..., c].copy_(src[..., c])
            if not self.max_performance:
                first = [*first, cost_engine._combine(*first)]
            return [t[0] for t in first]

    def assemble(self, outs, read=None) -> FrameCosts:
        """Gather the parts' outputs on the first part's device and read
        them back (blocks until every part finishes).  ``read(*tensors)``:
        the readback, host arrays or tensors of the gathered fields (e.g.
        ``ReadbackRing.read``); by default new host tensors.  A
        ``PartedFrame`` is already on its way to the ring: the current
        stream joins the part's (span ``latency.gather``) and its read
        returns the slot's arrays, ``read`` unused.  FrameCosts fields are
        [nCTU, 97840] host tensors.  Span ``latency.assemble``."""
        with span("latency.assemble"):
            if isinstance(outs, PartedFrame):
                with span("latency.gather"):
                    join(outs.stream)
                host = [torch.as_tensor(a[0]) for a in outs.read.read()]
            else:
                fields = self.gather(outs)
                host = ([t.cpu() for t in fields] if read is None
                        else [torch.as_tensor(a) for a in read(*fields)])
            if self.max_performance:
                host = [None, None, *host]
            return FrameCosts(*host, valid=self._valid)

    def __call__(self, frame, ref_frame=None) -> FrameCosts:
        return self.assemble(self.dispatch(frame, ref_frame))
