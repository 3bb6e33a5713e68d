"""The edges that 3840x2160 alone has among the reference's frame sizes,
on the port's plain path at a small size, held against the port's own
engine and golden model (no JAX compile).

A 3840x2160 frame is 17 CTU rows whose last is 112 samples: a sharded
engine pads it to whole bands (18 rows for two bands, 20 for four, the
last band of four all padding but for two rows), the latency engine
splits its classes over parts, and its bottom-right CTU, 509, is the
CLI's target CTU in chip_smoke.py's phase (m).  The same edges here at
128 samples wide: 368 high (3 CTU rows, the last of 112) for the engines,
240 high (a bottom CTU of 112 rows) for the CLI.  The engines against
JAX's are in test_torch_parallel.py, the card's in chip_smoke.py (m).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import chip_smoke
from vvc_mip_gpu_tpu_torch import cli
from vvc_mip_gpu_tpu_torch.constants import num_ctus
from vvc_mip_gpu_tpu_torch.golden import reference_model as gm
from vvc_mip_gpu_tpu_torch.golden.filters_golden import filter_frame
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models.cost_engine import (
    MipCostEngine, _validity_mask)
from vvc_mip_gpu_tpu_torch.parallel import ShardedMipCostEngine, make_mesh
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import (
    LatencyMipCostEngine)
from vvc_mip_gpu_tpu_torch.parallel.sharded_engine import _padded_height

CPU = torch.device("cpu")
FULL = ("sad", "satd", "min_sad_had")
FILTER = ("filterFrame_2d_int_quarterCtu", 2)
W, H = 128, 368  # 3 CTU rows, the last of 112 samples, as at 3840x2160
FRAME = np.random.default_rng(13).integers(0, 1024, (1, H, W),
                                           dtype=np.int32)
REF = np.random.default_rng(14).integers(0, 1024, (1, H, W), dtype=np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    """MipCostEngine's full report of FRAME with the distinct REF."""
    return MipCostEngine(W, H, device=CPU).compute_batch(
        torch.from_numpy(FRAME), torch.from_numpy(REF))


def _assert_equal(got, want, fields, valid=None):
    for field in fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.shape == b.shape, (field, a.shape, b.shape)
        bad = a != b if valid is None else (a != b) & valid
        assert not bad.any(), (f"{field}: {int(bad.sum())} mismatches at "
                               f"{bad.nonzero()[:5].tolist()}")


def test_uhd_geometry_and_its_padded_masks():
    """3840x2160: 510 CTUs in 17 rows, 49,494,960 valid entries a field
    (the count chip_smoke.py (m) compares), padded to 18 and 20 rows for
    2 and 4 bands with no valid entry in a padded CTU."""
    assert num_ctus(3840, 2160) == (30, 17, 510)
    valid = _validity_mask(3840, 2160)
    assert int(valid.sum()) == 49_494_960
    for n_space, rows in ((2, 18), (4, 20)):
        padded = _padded_height(2160, n_space)
        assert padded == rows * 128
        mask = _validity_mask(3840, 2160, padded)
        assert mask.shape == (rows * 30, valid.shape[1])
        np.testing.assert_array_equal(mask[:510], valid)
        assert not mask[510:].any()


@pytest.mark.parametrize("n_space", [2, 4])
def test_sharded_bands_over_the_112_row_ctu_row(n_space, single):
    """Bands of a (1, n_space) mesh over 3 CTU rows padded to 4, the last
    true row 112 samples, a reference distinct from the frame (so a halo
    row taken from the wrong frame shows): whole padded tensors equal
    MipCostEngine on the edge-padded frames, the true CTUs' valid CUs
    equal MipCostEngine on the true frame, and the mask marks every
    padded CU invalid."""
    engine = ShardedMipCostEngine(W, H, make_mesh(1, n_space,
                                                  [CPU] * n_space))
    assert engine.padded_height == 512
    frames, refs = torch.from_numpy(FRAME), torch.from_numpy(REF)
    got = engine(frames, refs)
    padded = MipCostEngine(W, engine.padded_height, device=CPU).compute_batch(
        engine.pad_frames(frames), engine.pad_frames(refs))
    _assert_equal(got, padded, FULL)
    n_ctu = num_ctus(W, H)[2]
    valid = torch.from_numpy(_validity_mask(W, H))
    assert torch.equal(got.valid[:n_ctu], valid)
    assert not got.valid[n_ctu:].any()
    true = type(got)(*(getattr(got, f)[:, :n_ctu] for f in FULL), None)
    _assert_equal(true, single, FULL, valid)


@pytest.mark.parametrize("max_performance", [True, False],
                         ids=["max-performance", "full-report"])
def test_latency_parts_over_the_112_row_ctu_row(max_performance, single):
    """The latency engine's 4 parts on the 3-row frame, on its original
    samples (max-performance) or with the distinct reference (full
    report): whole tensors equal MipCostEngine's."""
    engine = LatencyMipCostEngine(W, H, [CPU] * 4,
                                  max_performance=max_performance)
    if max_performance:
        got = engine(FRAME[0])
        want = MipCostEngine(W, H, True, CPU)(FRAME[0])
        _assert_equal(got, want, ("min_sad_had",))
        assert got.sad is None and got.satd is None
    else:
        got = engine(FRAME[0], REF[0])
        _assert_equal(got, type(got)(*(getattr(single, f)[0] for f in FULL),
                                     None), FULL)


def test_cli_target_ctu_of_the_112_row_bottom_ctu_is_the_golden_models(
        tmp_path, monkeypatch):
    """The CLI's target-CTU CSV of a filtered full-report run, 2 frames of
    128x240, CTU 1 (a bottom CTU of 112 rows, as CTU 509 at 3840x2160),
    against the C writer's export of the port's golden model's costs fed
    by the golden filters: byte for byte on every in-frame row of each
    POC, the identity columns on the out-of-frame rows (chip_smoke.py's
    check of (m.5))."""
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    width, height, ctu = 128, 240, 1
    prefix = str(tmp_path / "c_")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(
            ["-f", "2", "-s", f"{width}x{height}", "--Synthetic",
             "--FullDistortion", "--FilterType", FILTER[0], "--KernelIdx",
             str(FILTER[1]), "--TargetCTU", str(ctu), "-l", prefix]) == 0
    for poc, frame in enumerate(synthetic_frames(2, width, height).astype(
            np.int64)):
        golden = gm.frame_costs(frame, filter_frame(frame, *FILTER))
        assert not golden[0].valid[ctu].all()  # out-of-frame 64x64 CUs
        assert chip_smoke.target_golden_differences(
            f"{prefix}target_ctu{ctu}.csv", golden, width, ctu, poc,
            str(tmp_path)) == []
