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
read returns are therefore valid until the next-but-one read; a caller
that keeps one longer copies it.
"""

from __future__ import annotations

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.utils.timing import span

SLOTS = 2


class ReadbackRing:
    """Host buffers for the readbacks of one caller, ``SLOTS`` per field,
    reused round-robin; grown when a read needs more room."""

    def __init__(self):
        self._buffers: dict[tuple[int, int], torch.Tensor] = {}
        self._next = 0

    def _buffer(self, slot: int, field: int, t: torch.Tensor) -> torch.Tensor:
        flat = self._buffers.get((slot, field))
        if flat is None or flat.numel() < t.numel() or flat.dtype != t.dtype:
            flat = torch.empty(t.numel(), dtype=t.dtype,
                               pin_memory=t.device.type == "cuda")
            self._buffers[slot, field] = flat
        return flat[:t.numel()].view(t.shape)

    def read(self, *tensors: torch.Tensor | None
             ) -> tuple[np.ndarray | None, ...]:
        """Each tensor (None stays None) copied into this read's slot, as
        numpy arrays that alias the slot.  The copies are enqueued on each
        device's current stream, the stream that produced the tensors,
        and that stream is synchronized before the arrays are returned.
        Spans ``readback.read`` and, inside it, ``readback.wait`` (the
        synchronization)."""
        slot = self._next
        self._next = (slot + 1) % SLOTS
        with span("readback.read"):
            bufs = [None if t is None else
                    self._buffer(slot, k, t).copy_(t, non_blocking=True)
                    for k, t in enumerate(tensors)]
            with span("readback.wait"):
                for dev in {t.device for t in tensors
                            if t is not None and t.device.type == "cuda"}:
                    torch.cuda.current_stream(dev).synchronize()
        return tuple(None if b is None else b.numpy() for b in bufs)
