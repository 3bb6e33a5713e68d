"""The port's plain path against the port's golden model on whole 416x240
frames, the reference's smallest size (4 x 2 CTUs: a partial right CTU
column of 32 and a partial bottom CTU row of 112), full report, noise and
smooth: the port's counterpart of the JAX package's
tests/test_engine_vs_golden.py::test_416x240.  A file of its own (~18 s):
under ``--dist loadfile`` test_torch_golden.py runs on the worker that
then runs test_engine_vs_golden.py, the suite's longest file.  No JAX."""

import numpy as np
import pytest
import torch

from test_torch_golden import FIELDS, _assert_equal_on_valid_cus, _frame
from vvc_mip_gpu_tpu_torch.golden import reference_model as gm
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine

W, H = 416, 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_plain_path_equals_golden_416x240(content):
    """Every valid CU of the whole frame, SAD, SATD and minSadHad, and the
    validity mask against the golden model's per-group masks."""
    frame = (_frame(33, W, H) if content == "noise"
             else synthetic_frames(1, W, H, seed=34)[0].astype(np.int64))
    got = MipCostEngine(W, H, device="cpu")(frame)
    _assert_equal_on_valid_cus(got, gm.frame_costs(frame), FIELDS)
