"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA card and nvcc, and skip elsewhere.
Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port.)
Every class's cost-kernel instantiation is held against its plain version
on the same CUDA tensors, bit for bit, at 256x128 and at 608x192 (partial
right and bottom CTUs), in both output regimes, again on saturated
frames (all 1023, all 0, a 0/1023 checkerboard), and with misaligned
frames and outputs (the kernels' scalar loads and stores); so is the
reduced-prediction kernel for each SizeId, the inspect readback on the
card against the host's, and the filters on the card against the CPU.
"""

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu_torch.constants import (
    AVAILABLE_FILTERS,
    BOUNDARY_SIZE,
    num_ctus,
)
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models import cost_engine as tce
from vvc_mip_gpu_tpu_torch.models.inspect import inspect_ctu
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS
from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred

pytestmark = [
    pytest.mark.cuda,
    # a string condition: evaluated when each test runs, not at import
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA device"),
]


def _inputs(width, height, seed):
    rng = np.random.default_rng(seed)
    frames = np.stack([rng.integers(0, 1024, (height, width)),
                       synthetic_frames(1, width, height, seed=seed)[0]])
    ref = rng.integers(0, 1024, (2, height, width))
    halo = rng.integers(0, 1024, (2, width))
    return (torch.from_numpy(a.astype(np.int16)).cuda()
            for a in (frames, ref, halo))


@pytest.mark.parametrize("max_performance", [True, False])
@pytest.mark.parametrize("size", [(256, 128), (608, 192)])
@pytest.mark.parametrize("ci", range(17))
def test_kernel_matches_plain(ci, size, max_performance):
    width, height = size
    frames, ref, halo = _inputs(width, height, seed=ci)
    run = tce.class_runs(width, height, frames.device)[ci]
    shape = (2, num_ctus(width, height)[2], tce.PER_CTU)
    n_out = 1 if max_performance else 2
    # original samples at the frame top; distinct ref and a halo row below
    for refs, is_top in ((frames, True), (ref, False)):
        outs = [[torch.full(shape, -1, dtype=torch.int32, device="cuda")
                 for _ in range(n_out)] for _ in range(2)]
        args = (frames, refs, halo, is_top, run.plan, run.table, run.weights)
        run.kernel(*args, outs[0])
        run.kernel.plain(*args, outs[1])
        torch.cuda.synchronize()
        for k, p in zip(*outs):
            assert torch.equal(k, p), (
                f"{run.plan.shape.width}x{run.plan.shape.height}: "
                f"{int((k != p).sum())} entries differ")


def _saturated(content, width, height):
    """[2, H, W] int16 frames that push the prediction clamp and the
    largest SATD: all 1023, all 0, or a 0/1023 checkerboard (and its
    complement as the second frame)."""
    if content == "checker":
        yy, xx = np.mgrid[:height, :width]
        board = (yy + xx) % 2 * 1023
        frames = np.stack([board, 1023 - board])
    else:
        frames = np.full((2, height, width), 1023 if content == "max" else 0)
    return torch.from_numpy(frames.astype(np.int16)).cuda()


@pytest.mark.parametrize("max_performance", [True, False])
@pytest.mark.parametrize("size", [(256, 128), (608, 192)])
@pytest.mark.parametrize("content", ["max", "zero", "checker"])
@pytest.mark.parametrize("ci", range(17))
def test_redesigned_kernels_on_saturated_content(ci, content, size,
                                                 max_performance):
    """Every class's kernel against its plain version on saturated
    frames."""
    width, height = size
    frames = _saturated(content, width, height)
    run = tce.class_runs(width, height, frames.device)[ci]
    n_ctu = num_ctus(width, height)[2]
    outs = [[torch.full((2, n_ctu, tce.PER_CTU), -1, dtype=torch.int32,
                        device="cuda")
             for _ in range(1 if max_performance else 2)] for _ in range(2)]
    args = (frames, frames, frames[:, 0].contiguous(), True, run.plan,
            run.table, run.weights)
    run.kernel(*args, outs[0])
    run.kernel.plain(*args, outs[1])
    torch.cuda.synchronize()
    for k, p in zip(*outs):
        assert torch.equal(k, p), f"{int((k != p).sum())} entries differ"


@pytest.mark.parametrize("max_performance", [True, False])
@pytest.mark.parametrize("ci", range(17))
def test_kernel_with_misaligned_outputs(ci, max_performance):
    """Outputs one int32 off 16-byte alignment (views one element into a
    flat buffer) and frames one int16 off 8-byte alignment: the kernels'
    scalar loads and stores against the plain version."""
    width, height = 608, 192
    frames, ref, halo = _inputs(width, height, seed=ci + 40)
    shifted = torch.empty(frames.numel() + 1, dtype=torch.int16,
                          device="cuda")[1:].view(frames.shape)
    shifted.copy_(frames)
    run = tce.class_runs(width, height, frames.device)[ci]
    shape = (2, num_ctus(width, height)[2], tce.PER_CTU)
    n = int(np.prod(shape))
    n_out = 1 if max_performance else 2
    outs_k = [torch.full((n + 1,), -1, dtype=torch.int32,
                         device="cuda")[1:].view(shape) for _ in range(n_out)]
    outs_p = [torch.full(shape, -1, dtype=torch.int32, device="cuda")
              for _ in range(n_out)]
    assert all(o.data_ptr() % 16 == 4 for o in outs_k)
    args = (shifted, ref, halo, False, run.plan, run.table, run.weights)
    run.kernel(*args, outs_k)
    run.kernel.plain(*args, outs_p)
    torch.cuda.synchronize()
    for k, p in zip(outs_k, outs_p):
        assert torch.equal(k, p), f"{int((k != p).sum())} entries differ"


def test_engine_inputs_on_the_card():
    """uint16 frames from the host (synthetic_frames' type) give the same
    costs as int32 frames; an empty batch gives empty costs."""
    engine = tce.MipCostEngine(128, 128, max_performance=True)
    frames = synthetic_frames(2, 128, 128, seed=1)
    got = engine.compute_batch(frames).min_sad_had
    want = engine.compute_batch(frames.astype(np.int32)).min_sad_had
    assert got.device.type == "cuda" and torch.equal(got, want)
    empty = engine.compute_batch(np.zeros((0, 128, 128), np.int32))
    assert tuple(empty.min_sad_had.shape) == (0, 1, tce.PER_CTU)


def test_compute_batch_launches_each_kernel_per_class():
    width, height = 256, 128
    frames = next(iter(_inputs(width, height, seed=0)))
    engine = tce.MipCostEngine(width, height, max_performance=True)
    for k in KERNELS:
        k.launches = 0
    engine.compute_batch(frames)
    torch.cuda.synchronize()
    assert [k.launches for k in KERNELS] == [1, 7, 9]


@pytest.mark.parametrize("size_id", [0, 1, 2])
def test_pred_kernel_matches_plain(size_id):
    rng = np.random.default_rng(size_id)
    bs = BOUNDARY_SIZE[size_id]
    for n_cu in (1, 700, 40_000):
        red_t, red_l = (torch.from_numpy(rng.integers(
            0, 1024, (bs, n_cu)).astype(np.int32)).cuda() for _ in range(2))
        before = mip_reduced_pred.launches
        got = mip_reduced_pred(red_t, red_l, size_id)
        want = mip_reduced_pred.plain(red_t, red_l, size_id)
        torch.cuda.synchronize()
        assert mip_reduced_pred.launches == before + 1
        assert got.dtype == torch.int16 and got.shape == want.shape
        assert torch.equal(got, want), (
            f"SizeId {size_id}, {n_cu} CUs: "
            f"{int((got != want).sum())} samples differ")


@pytest.mark.parametrize("group_idx,ctu_idx", [(6, 0), (0, 3), (46, 5),
                                               (30, 4), (41, 2), (36, 5)])
def test_inspect_on_the_card_matches_the_host(group_idx, ctu_idx):
    """384x136: CTUs 3-5 are the partial bottom row."""
    rng = np.random.default_rng(group_idx)
    frame = rng.integers(0, 1024, (136, 384))
    ref = synthetic_frames(1, 384, 136, seed=group_idx)[0]
    before = mip_reduced_pred.launches
    dev = inspect_ctu(frame, ctu_idx, group_idx, ref_frame=ref,
                      from_engine=True)
    host = inspect_ctu(frame, ctu_idx, group_idx, ref_frame=ref)
    assert mip_reduced_pred.launches == before + 1
    assert sorted(dev) == sorted(host)
    for key, value in host.items():
        if key != "group":
            np.testing.assert_array_equal(dev[key], value, err_msg=key)


@pytest.mark.parametrize("ftype", AVAILABLE_FILTERS)
def test_filters_on_the_card_match_the_cpu(ftype):
    rng = np.random.default_rng(5)
    frames = np.stack([rng.integers(0, 1024, (136, 200)),
                       synthetic_frames(1, 200, 136, seed=5)[0]]).astype(
                           np.int32)
    cpu = torch.from_numpy(frames)
    for kidx in range(3 if "5x5" in ftype else 5):
        got = filter_frames(cpu.cuda(), ftype, kidx)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), filter_frames(cpu, ftype, kidx)), (
            f"{ftype}[{kidx}]")
