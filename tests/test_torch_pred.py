"""The port's reduced-prediction wrapper (vvc_mip_gpu_tpu_torch.ops.pred)
on the CPU, where it runs its plain version, against the JAX package's
Pallas kernel in interpret mode, bit for bit, for all three SizeIds with a
CU count that is no tile multiple."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vvc_mip_gpu_tpu.ops.pallas import pred as pallas_pred
from vvc_mip_gpu_tpu_torch.constants import BOUNDARY_SIZE
from vvc_mip_gpu_tpu_torch.mip_weights import matrices, weights_from_numpy
from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred

N_CU = 700  # not a multiple of the TPU kernel's CU tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boundaries(size_id, seed):
    rng = np.random.default_rng(seed)
    bs = BOUNDARY_SIZE[size_id]
    return (rng.integers(0, 1024, (bs, N_CU)).astype(np.int32)
            for _ in range(2))


@pytest.mark.parametrize("size_id", [0, 1, 2])
def test_matches_pallas_kernel(size_id):
    red_t, red_l = _boundaries(size_id, seed=11 + size_id)
    want = np.asarray(pallas_pred.reduced_prediction(
        jnp.asarray(red_t), jnp.asarray(red_l), size_id, cu_tile=512,
        interpret=True))[..., :N_CU]
    before = mip_reduced_pred.launches
    got = mip_reduced_pred(torch.from_numpy(red_t), torch.from_numpy(red_l),
                           size_id)
    assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # int16 boundaries (reduce_boundary's pass-through for 4-sample
    # sides) and explicit weights give the same prediction
    weights = weights_from_numpy(matrices(), "cpu")[size_id]
    again = mip_reduced_pred(torch.from_numpy(red_t).to(torch.int16),
                             torch.from_numpy(red_l).to(torch.int16),
                             size_id, weights)
    assert torch.equal(again, got)
    assert mip_reduced_pred.launches == before  # the CPU launches nothing


def test_wrapper_checks_its_inputs():
    red_t, red_l = (torch.from_numpy(a) for a in _boundaries(1, seed=3))
    with pytest.raises(ValueError, match="SizeId"):
        mip_reduced_pred(red_t, red_l, 3)
    with pytest.raises(ValueError, match="red_t"):
        mip_reduced_pred(red_t, red_l, 0)  # SizeId 0 has 2 samples a side
    with pytest.raises(ValueError, match="red_l"):
        mip_reduced_pred(red_t, red_l[:, :5], 1)
    with pytest.raises(ValueError, match="red_l"):
        mip_reduced_pred(red_t, red_l.float(), 1)
    with pytest.raises(ValueError, match="weights"):
        mip_reduced_pred(red_t, red_l, 1,
                         weights_from_numpy(matrices(), "cpu")[2])
    with pytest.raises(ValueError, match="no kernel"):
        mip_reduced_pred(red_t.to("meta"), red_l.to("meta"), 1)
    empty = torch.zeros((4, 0), dtype=torch.int32)
    assert tuple(mip_reduced_pred(empty, empty, 2).shape) == (12, 64, 0)
