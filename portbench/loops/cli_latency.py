"""``cli_latency``: one host frame at a time, closed loop, through the
CLI's ``--LatencyMode`` step (``LatencyMipCostEngine.dispatch``, then
``gather``, the ring and ``finish``).  Records each frame's time from
hand-over to its costs in host memory.

The host frames are 16-bit samples in pinned memory: a choice made for
steady runs, since a pageable upload inside ``dispatch`` moved its
median from process to process."""

from __future__ import annotations

import time

import torch

from portbench import loop
from portbench.judge import FIELDS_MAX_PERFORMANCE, Kept
from vvc_mip_gpu_tpu_torch import cli
from vvc_mip_gpu_tpu_torch.utils.config import EngineConfig


class Loop(loop.Loop):
    def setup(self):
        if self.filter is not None:
            raise ValueError("cli_latency drives unfiltered configurations "
                             "only")
        cfg = EngineConfig(
            width=self.width, height=self.height, n_frames=self.pool_size,
            max_performance=self.fields == FIELDS_MAX_PERFORMANCE,
            latency_mode=True)
        cfg.validate()
        _, self.enqueue, self.read = cli._searcher(cfg, self.device,
                                                   self.pool_size)
        self.warm_up()

    def make_pool(self):
        pool = super().make_pool().to(torch.int16).cpu()
        if self.device.type == "cuda":
            pool = pool.pin_memory()
        return pool.numpy()

    def step(self, i):
        k = i % self.pool_size
        t = time.perf_counter()
        with self.trace.span("latency.dispatch"):
            outs = self.enqueue(self.pool, None, [k])
        with self.trace.span("latency.assemble"):
            msh, sad, satd = self.read(outs, 1)
        self.latencies.append(time.perf_counter() - t)
        out = {"min_sad_had": msh, "sad": sad, "satd": satd}
        return Kept([k], {f: out[f] for f in self.fields})

    def release(self):
        self.enqueue = self.read = None
