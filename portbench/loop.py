"""What every loop a traffic mix drives shares: sizes, the pool of frames,
the warm-up and the measured window.

A traffic file names its ``entry``; ``portbench/loops/<entry>.py`` defines
``Loop``, a subclass of ``Loop`` here, which builds the program's objects
in ``setup`` and runs one step of the window in ``step``.  It takes the
configuration and the traffic's parameters, makes its frames from the
seed, warms up the cell's own shapes, runs the window and keeps what the
judge needs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.frames import make_frames
from portbench.judge import FIELDS_FULL, FIELDS_MAX_PERFORMANCE, Kept

# the profiled stretch of a traced window: it starts this many seconds in
# and lasts this long (both shortened to a third of a short window)
STRETCH_AT_S = 2.0
STRETCH_S = 3.0


def sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class Clock:
    """The measured window on the host's clock.  In a traced run it also
    holds the profiler over a steady stretch inside the window, with the
    devices drained at both ends of the stretch."""

    def __init__(self, seconds: float, trace, devices):
        self.seconds = seconds
        self.trace = trace
        self.devices = devices
        self.stretch_at = min(STRETCH_AT_S, seconds / 3)
        self.stretch_len = min(STRETCH_S, seconds / 3)
        self.state = "before"
        self.t0 = self.t_profile = 0.0

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def tick(self) -> bool:
        """After each step: True while the window lasts."""
        elapsed = time.perf_counter() - self.t0
        if self.trace.enabled:
            if self.state == "before" and elapsed >= self.stretch_at:
                sync(self.devices)
                self.trace.start_profile()
                # the stretch starts once the profiler runs: starting it
                # takes seconds
                self.state = "profiling"
                self.t_profile = time.perf_counter() - self.t0
            elif (self.state == "profiling"
                  and elapsed >= self.t_profile + self.stretch_len):
                sync(self.devices)
                self.trace.stop_profile()
                self.state = "after"
        # a traced window lasts until its stretch is whole
        return elapsed < self.seconds or self.state == "profiling"

    def finish(self) -> float:
        """Wait for the devices to finish every step; the window's
        seconds."""
        sync(self.devices)
        return time.perf_counter() - self.t0


class Loop:
    """One traffic mix's loop over the program.  ``devices``: the cards of
    the cell, as many as its ``chips``; a one-card loop uses the first."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices,
                 trace):
        self.width, self.height = config["width"], config["height"]
        self.fields = (FIELDS_MAX_PERFORMANCE if config["max_performance"]
                       else FIELDS_FULL)
        self.filter = (None if config["filter"] is None else
                       (config["filter"]["type"],
                        config["filter"]["kernel_idx"]))
        self.traffic = traffic
        self.batch = traffic["batch"]
        self.pool_size = traffic["pool_frames"]
        self.seed = seed
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.trace = trace
        self.pool = None
        self.kept: list[Kept] = []
        self.latencies: list[float] = []
        self.phases: dict[str, float] = {}  # set-up seconds by phase
        self._t = time.perf_counter()

    def phase(self, name: str) -> None:
        """Close the set-up phase ``name`` (since the previous one)."""
        t = time.perf_counter()
        self.phases[name] = t - self._t
        self._t = t

    def make_pool(self):
        return make_frames(self.pool_size, self.width, self.height,
                           self.seed, self.device)

    def batch_frames(self, i: int) -> list[int]:
        b = i % (self.pool_size // self.batch)
        return list(range(b * self.batch, (b + 1) * self.batch))

    def setup(self) -> None:
        """Build the program's objects, then ``warm_up``."""
        raise NotImplementedError

    def step(self, i: int) -> Kept:
        raise NotImplementedError

    def warm_up(self) -> None:
        self.phase("program")
        self.pool = self.make_pool()
        sync(self.devices)
        self.phase("pool")
        for i in range(self.traffic["warmup_steps"]):
            self.step(i)
        sync(self.devices)
        if self.trace.enabled:
            # the profiler's first start in a process takes seconds: take
            # it here, not inside the window
            self.trace.start_profile()
            self.step(0)
            sync(self.devices)
            self.trace.stop_profile()
        self.trace.reset()
        self.latencies.clear()
        self.phase("warm_up")

    def window(self, seconds: float) -> tuple[int, float]:
        """Run steps until the window closes: (frames done, seconds).
        Keeps the last ``keep_last`` steps' outputs and, where the traffic
        asks, the one at a step drawn from the seed."""
        early = -1
        if self.traffic.get("keep_early_below"):
            early = int(np.random.default_rng(
                [self.seed % (1 << 63), 0xea71]).integers(
                    self.traffic["keep_early_below"]))
        clock = Clock(seconds, self.trace, self.devices)
        last: list[Kept] = []
        n = 0
        first = self.traffic["warmup_steps"]  # the cycle goes on from there
        clock.start()
        while True:
            kept = self.step(first + n)
            if n == early:
                self.kept.append(kept)
            last = (last + [kept])[-self.traffic["keep_last"]:]
            n += 1
            if not clock.tick():
                break
        elapsed = clock.finish()
        self.kept.extend(k for k in last
                         if all(k is not x for x in self.kept))
        return n * len(last[-1].frames), elapsed

    def release(self) -> None:
        """Drop the program's objects (the judge keeps the outputs)."""
