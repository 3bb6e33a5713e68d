"""Device-to-host readback into a ring of reused host buffers.

The CLI reads every chunk's cost tensors back to the host.  Into new
pageable memory a 1080p frame's 52.8 MB minSadHad took 27.9 ms on the
H100, into a pinned buffer 1.03 ms (PERF.md §5).  A ring keeps
``SLOTS`` host buffers per output field, pinned when the tensors are on
CUDA, and each read takes the next slot.

Two slots are exactly enough for ``utils.pipeline.pipelined``: it
dispatches (and reads back) item i+1 while item i drains on the writer
thread, and it waits for drain i before it dispatches item i+2, so the
slot that read i+2 reuses is free.  With one slot, item i+1's readback
would overwrite the arrays drain i is still writing out.  The arrays a
read returns are therefore valid until the next-but-one read (for a read
in parts, until the next-but-one read's first part is copied); a caller
that keeps one longer copies it.

A read in parts (``ReadbackRing.parted``) hides the copy behind the
search that produces it: the caller searches a chunk's frames in parts
(``part_plan``) and hands each finished part to ``PartedRead.copy``,
which copies it into its rows of the slot on the ring's copy stream, one
stream per CUDA device, while the device's current stream goes on with
the next part.  The link (~55 GB/s) then runs beside the search in place
of after it.  On the CPU a copy is a plain synchronous copy and there is
nothing to overlap, so ``part_plan`` keeps a CPU chunk whole and its
caller reads it with ``ReadbackRing.read``.

A read can also arrive in blocks of columns (``PartedRead.copy_columns``):
the latency engine searches one frame's classes SizeId by SizeId, and each
SizeId writes one contiguous block of columns of the strided layout.  Each
block is one pitched copy (``csrc/mip_readback.cu``) on the copy stream:
torch's ``copy_`` into a column view of pinned memory goes through
contiguous temporaries and a copy on the host, so it would not overlap.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.ops import _build
from vvc_mip_gpu_tpu_torch.utils.timing import span

SLOTS = 2

# The least CTUs a part of a chunk holds on a CUDA device: the fewest at
# which the card's search time per CTU measured within ~3.5 % of a whole
# batch of 16's (one H100: 1920x1080 4 frames, 540 CTUs, 5.338 us a CTU
# against 5.173; 3840x2160 2 frames, 1020 CTUs, 5.331 against 5.182).
# Below it the class launches' tails show: 405 CTUs (3 frames at 1080p)
# +5.1 %, 510 (one 4K frame) +5.5 %, 135 (one 1080p frame) +33 %, and a
# part of one 1080p frame also lets the host's 17 launches, ~0.7 ms, set
# the pace.  At 4K the CLI's step read as many host frames/s with parts
# of 2 frames as with parts of 1 (198-199 against 198-203, on a card
# whose copies ran at ~43 GB/s), 187 with parts of 4, 136-138 in one
# pass; a part of 2 frames searches 3 % slower than a batch, one of 1
# frame 7 %.
MIN_PART_CTUS = 540


def part_plan(device_type: str, n_frames: int,
              ctus_per_frame: int) -> list[tuple[int, int]]:
    """[b0, b1) of each part of a chunk of ``n_frames`` frames of
    ``ctus_per_frame`` CTUs each: consecutive whole frames, as even as
    whole frames allow (the smaller parts first), each of at least
    ``MIN_PART_CTUS`` CTUs.  One part on any device but CUDA, and where
    the chunk has too few frames for two such parts."""
    per_part = -(-MIN_PART_CTUS // ctus_per_frame)
    n_parts = max(1, n_frames // per_part) if device_type == "cuda" else 1
    bounds = [n_frames * i // n_parts for i in range(n_parts + 1)]
    return list(zip(bounds, bounds[1:]))


class ReadbackRing:
    """Host buffers for the readbacks of one caller, ``SLOTS`` per field,
    reused round-robin; grown when a read needs more room."""

    def __init__(self):
        self._buffers: dict[tuple[int, int], torch.Tensor] = {}
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._next = 0

    def _take(self) -> int:
        slot = self._next
        self._next = (slot + 1) % SLOTS
        return slot

    def _buffer(self, slot: int, field: int, t: torch.Tensor,
                shape=None) -> torch.Tensor:
        """The slot's buffer of ``field`` for ``t``'s dtype, viewed as
        ``shape`` (``t``'s own by default)."""
        shape = t.shape if shape is None else shape
        numel = math.prod(shape)
        flat = self._buffers.get((slot, field))
        if flat is None or flat.numel() < numel or flat.dtype != t.dtype:
            flat = torch.empty(numel, dtype=t.dtype,
                               pin_memory=t.device.type == "cuda")
            self._buffers[slot, field] = flat
        return flat[:numel].view(shape)

    def read(self, *tensors: torch.Tensor | None
             ) -> tuple[np.ndarray | None, ...]:
        """Each tensor (None stays None) copied into this read's slot, as
        numpy arrays that alias the slot.  The copies are enqueued on each
        device's current stream, the stream that produced the tensors,
        and that stream is synchronized before the arrays are returned.
        Spans ``readback.read`` and, inside it, ``readback.wait`` (the
        synchronization)."""
        slot = self._take()
        with span("readback.read"):
            bufs = [None if t is None else
                    self._buffer(slot, k, t).copy_(t, non_blocking=True)
                    for k, t in enumerate(tensors)]
            with span("readback.wait"):
                for dev in {t.device for t in tensors
                            if t is not None and t.device.type == "cuda"}:
                    torch.cuda.current_stream(dev).synchronize()
        return tuple(None if b is None else b.numpy() for b in bufs)

    def parted(self, n: int) -> "PartedRead":
        """A read that arrives in parts along one axis of length ``n``, into
        the next slot: ``n`` frames copied by rows (``PartedRead.copy``),
        or ``n`` columns copied in blocks (``PartedRead.copy_columns``)."""
        return PartedRead(self, self._take(), n)

    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream


class PartedRead:
    """One read of ring slot ``slot``, filled part by part: ``copy`` each
    part of [n, ...] fields (or ``copy_columns`` each block of [..., n]
    fields) as soon as it is enqueued, then ``read``."""

    def __init__(self, ring: ReadbackRing, slot: int, n: int):
        self.ring = ring
        self.slot = slot
        self.n = n
        self.bufs: list[torch.Tensor | None] = []
        self.stream: torch.cuda.Stream | None = None  # the copies' stream

    def copy(self, b0: int, *tensors: torch.Tensor | None) -> None:
        """Copy each tensor (None stays None), one part [k, ...] of its
        field, into rows [b0, b0 + k) of the slot.  On CUDA the copy runs
        on the ring's copy stream of the tensors' device, once the work
        the device's current stream holds so far (the part's search) is
        done; the allocator keeps the tensors' memory until the copy has
        run.  Span ``readback.part``, timed on the copy stream."""
        device = next(t.device for t in tensors if t is not None)
        stream = None
        if device.type == "cuda":
            stream = self.stream = self.ring._copy_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
        if not self.bufs:
            self.bufs = [None if t is None else self.ring._buffer(
                self.slot, k, t, (self.n, *t.shape[1:]))
                for k, t in enumerate(tensors)]
        with torch.cuda.stream(stream), span("readback.part", device):
            for buf, t in zip(self.bufs, tensors):
                if t is None:
                    continue
                buf[b0:b0 + len(t)].copy_(t, non_blocking=True)
                if stream is not None:
                    t.record_stream(stream)

    def copy_columns(self, c0: int, *blocks: torch.Tensor | None) -> None:
        """Copy each block (None stays None), columns [..., k] of its field
        (views of a wider tensor, any row pitch), into columns [c0, c0 + k)
        of every row of the slot, whose fields are ``n`` columns wide; the
        slot's other columns are left as they are.  On CUDA one pitched
        copy a block on the ring's copy stream, ordered and kept alive as
        in ``copy``.  Span ``readback.part``, timed on the copy stream."""
        device = next(t.device for t in blocks if t is not None)
        stream = None
        if device.type == "cuda":
            stream = self.stream = self.ring._copy_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
        if not self.bufs:
            self.bufs = [None if t is None else self.ring._buffer(
                self.slot, k, t, (*t.shape[:-1], self.n))
                for k, t in enumerate(blocks)]
        with torch.cuda.stream(stream), span("readback.part", device):
            for buf, t in zip(self.bufs, blocks):
                if t is None:
                    continue
                dst = buf[..., c0:c0 + t.shape[-1]]
                if stream is None:
                    dst.copy_(t)
                    continue
                _copy_columns_to_host(dst, t, stream)
                t.record_stream(stream)

    def read(self) -> tuple[np.ndarray | None, ...]:
        """The slot's arrays, once every part's copy is done: the
        device's current stream waits for the copy stream, and is
        synchronized.  Spans ``readback.read`` and, inside it,
        ``readback.wait``."""
        with span("readback.read"), span("readback.wait"):
            if self.stream is not None:
                current = torch.cuda.current_stream(self.stream.device)
                current.wait_stream(self.stream)
                current.synchronize()
        return tuple(None if b is None else b.numpy() for b in self.bufs)


def _copy_columns_to_host(dst: torch.Tensor, src: torch.Tensor,
                          stream: torch.cuda.Stream) -> None:
    """Enqueue on ``stream`` the copy of the device block ``src`` into the
    pinned host block ``dst``: equal shapes and dtypes, unit column
    stride, the rows of each evenly pitched."""
    if (src.shape != dst.shape or src.dtype != dst.dtype
            or src.stride(-1) != 1 or dst.stride(-1) != 1):
        raise ValueError(f"copy_columns: a {tuple(src.shape)} {src.dtype} "
                         f"block into a {tuple(dst.shape)} {dst.dtype} one")
    width = src.shape[-1]
    src_rows, dst_rows = src.view(-1, width), dst.view(-1, width)
    size = src.element_size()
    with torch.cuda.device(src.device):
        err = _copier()(dst_rows.data_ptr(),
                        max(dst_rows.stride(0), width) * size,
                        src_rows.data_ptr(),
                        max(src_rows.stride(0), width) * size,
                        width * size, src_rows.shape[0], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy_columns: cudaMemcpy2DAsync failed with "
                           f"error {err}")


@functools.cache
def _copier():
    fn = _build.load_library("mip_readback").mip_copy_columns_to_host
    fn.argtypes = (ctypes.c_void_p, ctypes.c_size_t,  # dst, its pitch
                   ctypes.c_void_p, ctypes.c_size_t,  # src, its pitch
                   ctypes.c_size_t, ctypes.c_size_t,  # width bytes, rows
                   ctypes.c_void_p)  # stream
    fn.restype = ctypes.c_int
    return fn
