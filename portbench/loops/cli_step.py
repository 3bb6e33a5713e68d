"""``cli_step``: batches of frames held on the card through the CLI's
per-chunk step (``cli._searcher``: ``enqueue``, then ``read`` into the
readback ring's pinned host buffers), filtered first where the
configuration filters.  Counts frames whose costs are in host memory."""

from __future__ import annotations

from portbench import loop
from portbench.judge import FIELDS_MAX_PERFORMANCE, Kept
from vvc_mip_gpu_tpu_torch import cli
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
from vvc_mip_gpu_tpu_torch.utils.config import EngineConfig


class Loop(loop.Loop):
    def setup(self):
        ft, ki = self.filter if self.filter else (None, 0)
        cfg = EngineConfig(
            width=self.width, height=self.height, n_frames=self.pool_size,
            filter_type=ft, kernel_idx=ki,
            max_performance=self.fields == FIELDS_MAX_PERFORMANCE,
            batch_frames=self.batch)
        cfg.validate()
        _, self.enqueue, self.read = cli._searcher(cfg, self.device,
                                                   self.pool_size)
        self.warm_up()

    def step(self, i):
        idx = self.batch_frames(i)
        frames = self.pool[idx[0]:idx[-1] + 1]
        refs = None
        if self.filter is not None:
            with self.trace.span("filter", device=True):
                refs = filter_frames(frames, *self.filter)
        with self.trace.span("cli.search", device=True):
            costs = self.enqueue(frames, refs, list(range(len(idx))))
        with self.trace.span("cli.read", device=True):
            msh, sad, satd = self.read(costs, len(idx))
        out = {"min_sad_had": msh, "sad": sad, "satd": satd}
        self.trace.counters["readback_bytes"] += sum(
            a.nbytes for a in out.values() if a is not None)
        return Kept(idx, {f: out[f] for f in self.fields})

    def release(self):
        self.enqueue = self.read = None
