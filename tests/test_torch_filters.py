"""The port's filter family (vvc_mip_gpu_tpu_torch.ops.filters, on the CPU)
against the JAX package's ``filter_frames`` and its NumPy golden model,
bit for bit: all 8 variants x every KernelIdx, on a noise frame and a
smooth frame of a non-square size (so every edge and corner divisor
rule is exercised)."""

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu.golden import filters_golden as fg
from vvc_mip_gpu_tpu.ops import filters as jf
from vvc_mip_gpu_tpu_torch.constants import AVAILABLE_FILTERS
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.ops import filters as tf

H, W = 36, 52


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    rng = np.random.default_rng(21)
    return np.stack([rng.integers(0, 1024, (H, W)),
                     synthetic_frames(1, W, H, seed=3)[0]]).astype(np.int64)


def _kernel_indices(ftype):
    return range(3 if "5x5" in ftype else 5)


@pytest.mark.parametrize("ftype", AVAILABLE_FILTERS)
def test_filters_match_jax_and_golden(ftype):
    frames = _frames()
    for kidx in _kernel_indices(ftype):
        got = tf.filter_frames(torch.from_numpy(frames), ftype, kidx)
        assert got.dtype == torch.int32 and got.shape == (2, H, W)
        got = got.numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jf.filter_frames(frames, ftype, kidx)),
            err_msg=f"{ftype}[{kidx}] vs JAX filter_frames")
        for b in range(2):
            want = fg.filter_frame(frames[b], ftype, kidx)
            np.testing.assert_array_equal(
                got[b], want, err_msg=f"{ftype}[{kidx}] frame {b}")
            np.testing.assert_array_equal(
                tf.filter_frame(frames[b], ftype, kidx).numpy(), want)


@pytest.mark.parametrize("ftype", AVAILABLE_FILTERS)
def test_frames_smaller_than_the_kernel(ftype):
    """Frames of 1-3 samples a side: every tap of some samples falls
    outside the frame."""
    rng = np.random.default_rng(4)
    for h, w in ((3, 2), (1, 5), (2, 2)):
        frame = rng.integers(0, 1024, (h, w))
        for kidx in _kernel_indices(ftype):
            np.testing.assert_array_equal(
                tf.filter_frame(frame, ftype, kidx).numpy(),
                fg.filter_frame(frame, ftype, kidx),
                err_msg=f"{ftype}[{kidx}] {h}x{w}")


def test_batched_equals_single_and_keeps_the_input_type():
    frames = synthetic_frames(3, 40, 24, seed=9)  # uint16, as the CLI reads
    for ftype in ("filterFrame_2d_int_quarterCtu",
                  "filterFrame_1d_float_5x5"):
        got = tf.filter_frames(frames.astype(np.int32), ftype, 1)
        for b in range(3):
            assert torch.equal(got[b], tf.filter_frame(
                torch.from_numpy(frames[b].astype(np.int64)), ftype, 1))


def test_invalid_args():
    frame = _frames()[0]
    with pytest.raises(ValueError, match="unknown filter"):
        tf.filter_frame(frame, "no_such_filter")
    with pytest.raises(ValueError, match="out of range"):
        tf.filter_frame(frame, "filterFrame_1d_int_5x5", 3)
    with pytest.raises(ValueError, match="out of range"):
        tf.filter_frame(frame, "filterFrame_1d_int", -1)
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        tf.filter_frames(frame, "filterFrame_1d_int")
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        tf.filter_frame(frame[None], "filterFrame_1d_int")
