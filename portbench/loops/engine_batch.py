"""``engine_batch``: back-to-back batches of frames held on the card
through ``MipCostEngine.compute_batch``, the configuration's filter
(``filter_frames``) first where it has one; the costs stay on the card.
Counts frames whose costs are complete in device memory."""

from __future__ import annotations

from portbench import loop
from portbench.judge import FIELDS_MAX_PERFORMANCE, Kept
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames


class Loop(loop.Loop):
    def setup(self):
        self.engine = MipCostEngine(
            self.width, self.height,
            max_performance=self.fields == FIELDS_MAX_PERFORMANCE,
            device=self.device)
        self.warm_up()

    def step(self, i):
        idx = self.batch_frames(i)
        frames = self.pool[idx[0]:idx[-1] + 1]
        refs = None
        if self.filter is not None:
            with self.trace.span("filter", device=True):
                refs = filter_frames(frames, *self.filter)
        with self.trace.span("engine.search", device=True):
            costs = self.engine.compute_batch(frames, refs)
        return Kept(idx, {f: getattr(costs, f) for f in self.fields})

    def release(self):
        self.engine = None
