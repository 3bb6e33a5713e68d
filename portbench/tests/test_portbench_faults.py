"""A run with the timed path broken underneath judges itself not correct.

Each test drives a whole run of a tiny cell on the CPU (the program's
plain path; the look for a card is the only part left out) with one
fault planted in the program, and sees ``correct`` come out false.  The
faults a cell can have: a step that returns its state unchanged (the
previous step's costs), half of the batch left out (its costs copied from
the other half), and an answer altered where it is produced.  No cell
spans chips, so none can leave out an exchange between them; a latency
cell's batch is one frame, so it has no half to leave out.
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from vvc_mip_gpu_tpu_torch.models import cost_engine
from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

SEED = 2**31 + 3


def _run(root, cell):
    return harness.run(harness.load_cell(cell, root), SEED, 1.0, False,
                       ["cpu"], 0.0)


def _stale_engine(monkeypatch):
    """compute_batch hands back the previous call's costs."""
    original = cost_engine.MipCostEngine.compute_batch
    previous = {}

    def stale(self, frames, refs=None):
        out = previous.get("costs")
        previous["costs"] = original(self, frames, refs)
        return out if out is not None else previous["costs"]

    monkeypatch.setattr(cost_engine.MipCostEngine, "compute_batch", stale)


def _stale_ring(monkeypatch):
    """After its first read the ring hands back its buffers without
    copying the new costs into them."""
    original = ReadbackRing.read
    calls = {"n": 0}

    def stale(self, *tensors):
        calls["n"] += 1
        if calls["n"] <= 1:
            return original(self, *tensors)
        slot = self._next
        self._next = (slot + 1) % 2
        return tuple(None if t is None else self._buffer(slot, k, t).numpy()
                     for k, t in enumerate(tensors))

    monkeypatch.setattr(ReadbackRing, "read", stale)


def _half_batch(monkeypatch):
    """The second half of each batch gets the first half's costs."""
    original = cost_engine.MipCostEngine.compute_batch

    def half(self, frames, refs=None):
        n = frames.shape[0] // 2
        costs = original(self, frames[:n], None if refs is None else refs[:n])
        return cost_engine.FrameCosts(*(
            None if t is None else torch.cat([t, t[:frames.shape[0] - n]])
            for t in (costs.sad, costs.satd, costs.min_sad_had,
                      costs.valid)))

    monkeypatch.setattr(cost_engine.MipCostEngine, "compute_batch", half)


def _altered(monkeypatch):
    """Every 997th cost is one more than it should be."""
    original = cost_engine._run_classes

    def altered(*args, **kwargs):
        outs = original(*args, **kwargs)
        for out in outs:
            out.view(-1)[::997] += 1
        return outs

    monkeypatch.setattr(cost_engine, "_run_classes", altered)


FAULTS = {"stale_engine": _stale_engine, "stale_ring": _stale_ring,
          "half_batch": _half_batch, "altered": _altered}
CASES = [
    ("tiny-resident", "stale_engine"), ("tiny-resident", "half_batch"),
    ("tiny-resident", "altered"),
    ("tiny-alt-resident", "altered"),
    ("tiny-alt-stream", "stale_engine"), ("tiny-alt-stream", "stale_ring"),
    ("tiny-alt-stream", "half_batch"), ("tiny-alt-stream", "altered"),
    ("tiny-single", "stale_ring"), ("tiny-single", "altered"),
]


@pytest.mark.parametrize("cell", ["tiny-resident", "tiny-alt-resident",
                                  "tiny-alt-stream", "tiny-single"])
def test_sound_run_is_correct(tiny_root, cpu_platform, cell):
    result = _run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["mismatched_costs"]["value"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny_root, cpu_platform, monkeypatch, cell,
                              fault):
    FAULTS[fault](monkeypatch)
    result = _run(tiny_root, cell)
    assert not result["correct"]
    assert result["checks"]["mismatched_costs"]["value"] > 0
    assert result["failed"] > 0
