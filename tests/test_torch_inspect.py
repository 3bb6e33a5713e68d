"""The port's inspection readbacks (vvc_mip_gpu_tpu_torch.models.inspect)
against the JAX package's ``inspect_ctu`` golden mode (NumPy), bit for
bit, in both modes on the CPU: groups of each SizeId, the partial bottom
and right CTUs of a 192x136 frame, and a distinct reference frame.  The
golden model clips the origins of out-of-frame CUs where the engines
replicate the frame's edge, so on partial CTUs those CUs are held against
the JAX package's device-mode readback instead."""

import io

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu.models import inspect as jinspect
from vvc_mip_gpu_tpu_torch.constants import GROUPS
from vvc_mip_gpu_tpu_torch.models.inspect import inspect_ctu, report_target_ctu
from vvc_mip_gpu_tpu_torch.ops.geometry import _group_plan
from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred

W, H = 192, 136  # 2x2 CTUs: the right column 64 wide, the bottom row 8 high
RNG = np.random.default_rng(9)
FRAME = RNG.integers(0, 1024, size=(H, W), dtype=np.int64)
REF = RNG.integers(0, 1024, size=(H, W), dtype=np.int64)
STAGES = ("ref_t", "ref_l", "red_t", "red_l", "reduced_prediction",
          "upsampled_prediction")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _valid_cus(group_idx, ctu_idx):
    gp = _group_plan(group_idx, W, H)
    return gp.to_ctu_layout(gp.valid)[ctu_idx]


# (group, CTU): 16x16, 64x64, 4x4 and three SizeId1 groups in the full
# CTU 0; partial CTUs 1 (right), 2 (bottom) and 3 (both).
CASES = [(6, 0), (0, 0), (46, 0), (30, 0), (36, 0), (41, 0),
         (2, 1), (46, 2), (33, 3), (40, 1), (20, 3)]


@pytest.mark.parametrize("from_engine", [False, True])
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("group_idx,ctu_idx", CASES)
def test_matches_jax_golden(group_idx, ctu_idx, with_ref, from_engine):
    ref = REF if with_ref else None
    gold = jinspect.inspect_ctu(FRAME, ctu_idx, group_idx, ref_frame=ref)
    got = inspect_ctu(FRAME, ctu_idx, group_idx, ref_frame=ref,
                      from_engine=from_engine, device="cpu")
    assert sorted(got) == sorted(gold)
    assert got["group"] == gold["group"] == GROUPS[group_idx].name
    np.testing.assert_array_equal(got["positions"], gold["positions"])
    valid = _valid_cus(group_idx, ctu_idx)
    for key in STAGES:
        if key not in gold:
            continue
        assert got[key].dtype == np.int64
        assert got[key].shape == gold[key].shape, key
        np.testing.assert_array_equal(got[key][valid], gold[key][valid],
                                      err_msg=f"stage {key}")


def test_partial_ctu_matches_jax_device_mode():
    """Every CU of the bottom-right CTU, out-of-frame ones included,
    against the JAX package's device-mode readback (its engine's SoA
    stages, one compile)."""
    group_idx, ctu_idx = 36, 3  # NA_4x16_G123: 8 of its rows are in frame
    want = jinspect.inspect_ctu(FRAME, ctu_idx, group_idx, ref_frame=REF,
                                from_engine=True)
    assert not _valid_cus(group_idx, ctu_idx).all()
    for from_engine in (False, True):
        got = inspect_ctu(FRAME, ctu_idx, group_idx, ref_frame=REF,
                          from_engine=from_engine, device="cpu")
        for key in STAGES:
            np.testing.assert_array_equal(
                got[key], np.asarray(want[key], np.int64),
                err_msg=f"stage {key} from_engine={from_engine}")


def test_engine_mode_goes_through_the_pred_wrapper(monkeypatch):
    calls = []
    real = type(mip_reduced_pred).__call__

    def spy(self, *args, **kwargs):
        calls.append(args[2])
        return real(self, *args, **kwargs)

    monkeypatch.setattr(type(mip_reduced_pred), "__call__", spy)
    inspect_ctu(FRAME, 0, 30, from_engine=True, device="cpu")
    inspect_ctu(FRAME, 0, 30, from_engine=False)
    assert calls == [1]  # the host mode runs the plain version directly


def test_arguments_are_checked():
    with pytest.raises(ValueError, match="CTU 4"):
        inspect_ctu(FRAME, 4, 0)
    with pytest.raises(ValueError, match="group_idx"):
        inspect_ctu(FRAME, 0, 47)
    with pytest.raises(ValueError, match="shape"):
        inspect_ctu(FRAME, 0, 0, ref_frame=REF[:128])


def test_report_target_ctu_prints_the_jax_text():
    rng = np.random.default_rng(2)
    msh, sad, satd = (rng.integers(0, 5000, (4, 97840)) for _ in range(3))
    for kwargs in ({}, {"sad": sad, "satd": satd}):
        want, got = io.StringIO(), io.StringIO()
        jinspect.report_target_ctu(msh, W, 3, file=want, **kwargs)
        report_target_ctu(torch.from_numpy(msh), W, 3, file=got,
                          **{k: torch.from_numpy(v)
                             for k, v in kwargs.items()})
        assert got.getvalue() == want.getvalue()
        assert got.getvalue().startswith("=== DISTORTION, CTU 3 @ (128,128)")
