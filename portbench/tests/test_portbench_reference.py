"""The plain reference and the op model against the program's own
oracles, and the control that a lower precision has to fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, harness, roofline
from portbench.reference import costs, filters
from portbench.reference.tables import FILTERS, PER_CTU
from vvc_mip_gpu_tpu_torch.constants import AVAILABLE_FILTERS
from vvc_mip_gpu_tpu_torch.golden import filters_golden, reference_model
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.tools import roofline as program_roofline

# 2x2 CTUs: a right column of 32 and a bottom row of 56 samples, as at
# 1080p; a 3x2 frame's third CTU column is partial
W, H = 160, 184
SIZES = [(416, 240), (832, 480), (1280, 720), (1920, 1080), (3840, 2160)]


def _frame(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-6, 7, (H, W)), axis=1) + 512
    return np.clip(smooth + rng.integers(-20, 21, (H, W)), 0, 1023)


@pytest.mark.parametrize("filtered", [False, True])
def test_reference_equals_golden_model_and_plain_path(filtered):
    frame = _frame(3 + filtered)
    ref = (filters_golden.filter_frame(frame, "filterFrame_2d_int_quarterCtu",
                                       2) if filtered else None)
    golden = reference_model.frame_costs(frame, ref)
    n = next(iter(golden.values())).sad.shape[0]
    valid = np.concatenate([np.repeat(golden[g].valid,
                                      golden[g].sad.shape[-1], axis=1)
                            for g in sorted(golden)], axis=1)
    frames = torch.from_numpy(frame)[None]
    refs = None if ref is None else torch.from_numpy(ref)[None]
    sad, satd, msh, v = costs.ctu_costs(frames, refs, [0] * n, range(n))
    assert (v.numpy() == valid).all()
    for field, got in (("sad", sad), ("satd", satd), ("min_sad_had", msh)):
        assert (got.numpy() == reference_model.flatten_strided(
            golden, field)).all(), field
    plain = MipCostEngine(W, H, max_performance=False, device="cpu")(
        frame, ref)
    for field, got in (("sad", sad), ("satd", satd), ("min_sad_had", msh)):
        p = getattr(plain, field).numpy()
        assert (p[valid] == got.numpy()[valid]).all(), field
    assert msh.shape == (n, PER_CTU)


def test_reference_picks_ctus_of_several_frames():
    frames = torch.from_numpy(np.stack([_frame(5), _frame(6)]))
    whole = [costs.ctu_costs(frames[i:i + 1], None, [0] * 4, range(4))[2]
             for i in range(2)]
    picked = costs.ctu_costs(frames, None, [1, 0, 1], [3, 2, 0], chunk=2)[2]
    assert (picked[0] == whole[1][3]).all()
    assert (picked[1] == whole[0][2]).all()
    assert (picked[2] == whole[1][0]).all()


def test_filters_equal_the_filter_oracle():
    assert FILTERS == AVAILABLE_FILTERS
    frame = _frame(7)
    for ft in FILTERS:
        for k in range(3):
            got = filters.filter_frames(torch.from_numpy(frame)[None], ft, k)
            assert (got[0].numpy() == filters_golden.filter_frame(
                frame, ft, k)).all(), (ft, k)


@pytest.mark.parametrize("size", SIZES)
def test_roofline_equals_the_programs_op_model(size):
    ours = roofline.class_work(*size, 16)
    theirs = program_roofline.class_work(*size, 16)
    key = ("class", "n_cu", "ops", "bytes")
    assert [[r[k] for k in key] for r in ours] == [
        [r[k] for k in key] for r in theirs]
    assert roofline.search_bound_ms(*size, 16) == pytest.approx(
        program_roofline.report(*size, 16, 132, 1980.0)["bound_ms"],
        rel=1e-12)


@pytest.mark.parametrize("cell", ["tiny-resident", "tiny-alt-stream"])
def test_control_in_int16_is_not_correct(tiny_root, cell):
    reading = control.control_reading(harness.load_cell(cell, tiny_root),
                                      2**31 + 11, torch.device("cpu"))
    assert reading["judged_costs"] > 0
    assert reading["mismatched_costs"] > 0
