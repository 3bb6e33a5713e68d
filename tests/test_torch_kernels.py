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
card against the host's, and the filter kernel on the card against its
plain version on the CPU (every variant and KernelIdx, one launch a call;
frames smaller than the kernel, saturated, of a ragged size, int16 (cast
to int32 by the wrapper), negative samples, a non-contiguous slice, and a
3840x2160 batch).
The multi-device engines run the kernels on one card under a (2, 2) mesh
(four shards, four streams, real halo rows between bands) and as a
4-part latency engine (four class subsets on four streams), each against
MipCostEngine, with their launch counts.  The full report at 1920x1080
through ``compute_batch`` launches what the max-performance regime
launches, times its minSadHad combine on the card and equals the plain
path.
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
from vvc_mip_gpu_tpu_torch.parallel import ShardedMipCostEngine, make_mesh
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine

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
        before = filter_frames.launches
        got = filter_frames(cpu.cuda(), ftype, kidx)
        assert filter_frames.launches == before + 1
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), filter_frames(cpu, ftype, kidx)), (
            f"{ftype}[{kidx}]")


def _filter_case(case: str) -> list[torch.Tensor]:
    """The frames of one edge case of the filter kernel, on the card."""
    rng = np.random.default_rng(11)
    if case == "smaller than the kernel":
        return [torch.from_numpy(rng.integers(0, 1024, (2, h, w)).astype(
            np.int32)).cuda() for h, w in ((1, 1), (2, 3), (4, 4))]
    if case == "saturated":
        check = (np.indices((67, 90)).sum(0) % 2) * 1023
        return [torch.from_numpy(np.stack([np.full((67, 90), 1023), check,
                                           np.zeros((67, 90))]).astype(
            np.int32)).cuda()]
    noise = rng.integers(0, 1024, (3, 131, 197))
    if case == "ragged":  # no multiple of the tile or vector width
        return [torch.from_numpy(noise.astype(np.int32)).cuda()]
    if case == "int16":  # cast to int32 by the wrapper
        return [torch.from_numpy(noise.astype(np.int16)).cuda(),
                torch.from_numpy(noise[:, :, :196].astype(np.int16)).cuda()]
    if case == "negative":  # the floor division's negative numerators
        signed = rng.integers(-1024, 1024, (3, 131, 196))
        return [torch.from_numpy(signed.astype(np.int32)).cuda(),
                torch.from_numpy(signed[:2, 7:, :131].astype(np.int16)).cuda()]
    pool = torch.from_numpy(rng.integers(0, 1024, (6, 140, 264)).astype(
        np.int32)).cuda()
    return [pool[1::2, 3:, 5:261]]  # a non-contiguous slice of a pool


@pytest.mark.parametrize("case", ["smaller than the kernel", "saturated",
                                  "ragged", "int16", "negative",
                                  "pool slice"])
@pytest.mark.parametrize("ftype", AVAILABLE_FILTERS)
def test_filter_kernel_edge_cases(ftype, case):
    """Each variant and KernelIdx on the card, one launch a call, against
    the plain version on the CPU, bit for bit."""
    for frames in _filter_case(case):
        cpu = frames.cpu().to(torch.int32)
        for kidx in range(3 if "5x5" in ftype else 5):
            before = filter_frames.launches
            got = filter_frames(frames, ftype, kidx)
            assert filter_frames.launches == before + 1
            assert got.dtype == torch.int32 and got.shape == frames.shape
            want = filter_frames.plain(cpu, ftype, kidx)
            assert torch.equal(got.cpu(), want), (
                f"{ftype}[{kidx}] {case} {tuple(frames.shape)}: "
                f"{int((got.cpu() != want).sum())} samples differ")


def test_filter_kernel_3840x2160():
    """One 3840x2160 batch of 2 under the benchmark's filter."""
    frames = np.stack([
        np.random.default_rng(12).integers(0, 1024, (2160, 3840)),
        synthetic_frames(1, 3840, 2160, seed=12)[0]]).astype(np.int32)
    cpu = torch.from_numpy(frames)
    before = filter_frames.launches
    got = filter_frames(cpu.cuda(), "filterFrame_2d_int_quarterCtu", 2)
    assert filter_frames.launches == before + 1
    assert torch.equal(got.cpu(), filter_frames.plain(
        cpu, "filterFrame_2d_int_quarterCtu", 2))


def _regime_inputs(regime, n, width, height, seed):
    """n host frames (noise and smooth) and, in the filtered regime, their
    filtered references; (frames, refs or None, max_performance): the
    original regime is the max-performance one, the filtered regime the
    full report."""
    rng = np.random.default_rng(seed)
    frames = np.concatenate([
        rng.integers(0, 1024, (n - n // 2, height, width)),
        synthetic_frames(n // 2, width, height, seed=seed)]).astype(np.int32)
    if regime == "original":
        return frames, None, True
    refs = filter_frames(torch.from_numpy(frames),
                         "filterFrame_2d_int_quarterCtu", 2).numpy()
    return frames, refs, False


def _assert_costs_equal(got, want, fields):
    for field in fields:
        g, w = getattr(got, field).cpu(), getattr(want, field).cpu()
        assert g.shape == w.shape, (field, g.shape, w.shape)
        assert torch.equal(g, w), f"{field}: {int((g != w).sum())} differ"


@pytest.mark.parametrize("regime", ["original", "filtered"])
def test_sharded_mesh_on_one_card(regime):
    """A (2, 2) mesh of cuda:0 four times at 608x192 (padded to 256 rows):
    whole padded tensors equal MipCostEngine on the edge-padded frames;
    each shard launches each kernel once per class."""
    width, height = 608, 192
    frames, refs, mp = _regime_inputs(regime, 4, width, height, seed=21)
    mesh = make_mesh(2, 2, [torch.device("cuda", 0)] * 4)
    engine = ShardedMipCostEngine(width, height, mesh, max_performance=mp)
    for k in KERNELS:
        k.launches = 0
    got = engine(frames, refs)
    torch.cuda.synchronize()
    assert [k.launches for k in KERNELS] == [4, 28, 36]
    assert got.min_sad_had.device == torch.device("cuda", 0)
    want = tce.MipCostEngine(width, engine.padded_height,
                             max_performance=mp).compute_batch(
        engine.pad_frames(frames),
        None if refs is None else engine.pad_frames(refs))
    fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
    _assert_costs_equal(got, want, fields)


@pytest.mark.parametrize("regime", ["original", "filtered"])
def test_latency_engine_four_parts_on_one_card(regime):
    """4 class subsets of one 608x192 host frame on four streams of cuda:0:
    whole tensors equal MipCostEngine; one launch per class in all."""
    width, height = 608, 192
    frames, refs, mp = _regime_inputs(regime, 1, width, height, seed=22)
    ref = None if refs is None else refs[0]
    engine = LatencyMipCostEngine(width, height,
                                  [torch.device("cuda", 0)] * 4,
                                  max_performance=mp)
    for k in KERNELS:
        k.launches = 0
    got = engine(frames[0], ref)
    assert [k.launches for k in KERNELS] == [1, 7, 9]
    want = tce.MipCostEngine(width, height, max_performance=mp)(frames[0],
                                                                ref)
    fields = ("min_sad_had",) if mp else ("sad", "satd", "min_sad_had")
    _assert_costs_equal(got, want, fields)


def test_readback_ring_pins_and_reuses_on_the_card():
    """The CLI's readback ring on the card: pinned host buffers, the
    values of the device tensors, two slots used in turn."""
    from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

    ring = ReadbackRing()
    a = torch.arange(97840 * 3, dtype=torch.int32, device="cuda").view(3, -1)
    first, none = ring.read(a, None)
    second, = ring.read(a[1:] * 2)
    third, = ring.read(a + 5)
    assert none is None
    np.testing.assert_array_equal(second, (a[1:] * 2).cpu().numpy())
    np.testing.assert_array_equal(third, (a + 5).cpu().numpy())
    np.testing.assert_array_equal(first, third)  # slot 0 again
    assert all(buf.is_pinned() for buf in ring._buffers.values())


def test_full_report_at_1920x1080():
    """The full report (SAD, SATD, minSadHad) through ``compute_batch`` at
    1920x1080, batch 2: the same 17 launches as the max-performance
    regime, span ``engine.combine`` timed on the card, and the three
    planes equal to the plain path's, whole (the CTUs drawn from the seed
    included), with minSadHad min(2 SAD, SATD) of the plain planes."""
    from vvc_mip_gpu_tpu_torch.utils import timing

    width, height = 1920, 1080
    frames = torch.from_numpy(synthetic_frames(2, width, height, seed=20)
                              .astype(np.int32)).cuda()
    launches, costs = {}, None
    for max_performance in (True, False):
        engine = tce.MipCostEngine(width, height,
                                   max_performance=max_performance)
        engine.compute_batch(frames)  # builds and loads the kernels
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        timing.clear()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            costs = engine.compute_batch(frames)
            torch.cuda.synchronize()
        launches[max_performance] = sum(k.launches for k in KERNELS)
        combine = timing.device_ms("engine.combine")
        if max_performance:
            assert combine == [] and costs.sad is None
        else:
            assert len(combine) == 1 and combine[0] > 0
        timing.clear()
    assert launches == {True: 17, False: 17}

    samples = frames.to(torch.int16)
    n_ctu = num_ctus(width, height)[2]
    plain = [torch.full((2, n_ctu, tce.PER_CTU), -1, dtype=torch.int32,
                        device="cuda") for _ in range(2)]
    for run in tce.class_runs(width, height, samples.device):
        run.kernel.plain(samples, samples, samples[:, 0].contiguous(), True,
                         run.plan, run.table, run.weights, plain)
    want = (*plain, torch.minimum(2 * plain[0], plain[1]))
    ctus = np.random.default_rng(2**31 + 20).choice(n_ctu, 2, replace=False)
    for name, got, w in zip(("sad", "satd", "min_sad_had"),
                            (costs.sad, costs.satd, costs.min_sad_had), want):
        assert torch.equal(got[:, ctus], w[:, ctus]), name
        assert torch.equal(got, w), (
            f"{name}: {int((got != w).sum())} entries differ")
