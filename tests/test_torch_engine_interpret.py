"""The port's MipCostEngine (plain path, on the CPU) against the JAX
MipCostEngine with its Pallas kernels in interpret mode, whole tensors.

A file of its own: tracing and compiling the interpret-mode kernels is
the slowest single step of the port's CPU tests, and under
``--dist loadfile`` a file of its own can run beside test_torch_engine.py
on another worker.
"""

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu.models import cost_engine as jce
from vvc_mip_gpu_tpu_torch.models import cost_engine as tce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and idle OpenMP threads would spin on cores the JAX tests use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_engine_matches_jax_pallas_interpret():
    """Against the Pallas kernels themselves: the JAX engine with its
    kernels in interpret mode (as tests/test_engine_vs_golden.py runs
    them), whole tensors."""
    width, height = 128, 128
    frame = np.random.default_rng(5).integers(
        0, 1024, (height, width)).astype(np.int32)
    old = jce._PALLAS_OVERRIDE, jce._PALLAS_INTERPRET
    jce._PALLAS_OVERRIDE, jce._PALLAS_INTERPRET = True, True
    try:
        exp = jce.MipCostEngine(width, height, max_performance=True)(frame)
        exp_msh = np.asarray(exp.min_sad_had)
    finally:
        jce._PALLAS_OVERRIDE, jce._PALLAS_INTERPRET = old
    got = tce.MipCostEngine(width, height, max_performance=True,
                            device="cpu")(frame)
    np.testing.assert_array_equal(exp_msh, got.min_sad_had.numpy())
