"""The port's MipCostEngine (plain path, on the CPU) against the JAX
package's cost search, on whole tensors: every CU including the
out-of-frame ones (both fill them from edge replication), plus ``valid``,
bit for bit.  The JAX side is ``compute_ext`` and ``_validity_mask``, what
the JAX MipCostEngine runs, compiled once per frame size and regime with
``is_top`` traced, so the frame-top and the halo cases share one compile.
The JAX MipCostEngine itself, with its Pallas kernels in interpret mode,
is compared in test_torch_engine_interpret.py.

Inputs are made with numpy from a seed and handed to both sides.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from vvc_mip_gpu_tpu.models import cost_engine as jce
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models import cost_engine as tce
from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

FIELDS = ("sad", "satd", "min_sad_had", "valid")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and idle OpenMP threads would spin on cores the JAX tests use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_costs_equal(exp, got, what):
    for field in FIELDS:
        e, g = getattr(exp, field), getattr(got, field)
        if e is None:
            assert g is None, f"{what}: {field} should be None"
            continue
        e = np.asarray(e).astype(np.int64)
        g = g.numpy().astype(np.int64)
        assert e.shape == g.shape, f"{what} {field}: {e.shape} vs {g.shape}"
        bad = e != g
        assert not bad.any(), (f"{what} {field}: {bad.sum()} mismatches at "
                               f"{np.argwhere(bad)[:5]}")


@functools.cache
def _jax_compute_ext(width, height, max_performance):
    """jce.compute_ext compiled for one frame size and regime; frame, ref,
    halo row and is_top are traced."""
    return jax.jit(functools.partial(jce.compute_ext, width=width,
                                     height=height,
                                     max_performance=max_performance))


def _jax_costs(frame, ref, width, height, max_performance):
    """The JAX engine's FrameCosts of one frame (its _compute: the frame's
    top slab, the halo row being any row)."""
    sad, satd, msh = _jax_compute_ext(width, height, max_performance)(
        frame, ref, ref[0], True)
    return jce.FrameCosts(sad=sad, satd=satd, min_sad_had=msh,
                          valid=jce._validity_mask(width, height))


def _frames(width, height, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (height, width)).astype(np.int32),
            synthetic_frames(1, width, height, seed=seed)[0].astype(np.int32),
            rng.integers(0, 1024, (height, width)).astype(np.int32))


@pytest.mark.parametrize("max_performance", [True, False])
@pytest.mark.parametrize("size", [(128, 128), (608, 192)])
def test_engine_matches_jax(size, max_performance):
    """Random and smooth content in the original-samples regime, and a
    distinct reference frame (alternative-samples regime)."""
    width, height = size
    noise, smooth, ref = _frames(width, height, seed=width + height)
    teng = tce.MipCostEngine(width, height, max_performance=max_performance,
                             device="cpu")
    for name, frame in (("noise", noise), ("smooth", smooth)):
        _assert_costs_equal(
            _jax_costs(frame, frame, width, height, max_performance),
            teng(frame), name)
    _assert_costs_equal(
        _jax_costs(smooth, ref, width, height, max_performance),
        teng(smooth, ref), "distinct ref")


def test_compute_ext_inner_slab_with_halo():
    """compute_ext on a slab that is not the frame's top (is_top=False):
    the top boundaries of the first CU row and the frame-left corner rule
    come from the halo row (the compile of test_engine_matches_jax's
    608x192 full-report case)."""
    width, height = 608, 192
    frame, _, ref = _frames(width, height, seed=7)
    halo = np.random.default_rng(8).integers(0, 1024, width).astype(np.int32)
    exp = _jax_compute_ext(width, height, False)(frame, ref, halo, False)
    got = tce.compute_ext(*(torch.from_numpy(a[None])
                            for a in (frame, ref, halo)),
                          False, width, height)
    for e, g, name in zip(exp, got, ("sad", "satd", "min_sad_had")):
        np.testing.assert_array_equal(np.asarray(e), g[0].numpy(), name)


def test_compute_batch_matches_jax():
    """B = 2 in one call against the JAX side frame by frame (its
    compiled one-frame function, shared with test_engine_matches_jax)."""
    width, height = 128, 128
    noise, smooth, _ = _frames(width, height, seed=3)
    got = tce.MipCostEngine(width, height, max_performance=True,
                            device="cpu").compute_batch(
                                np.stack([noise, smooth]))
    for b, frame in enumerate((noise, smooth)):
        exp = _jax_costs(frame, frame, width, height, True)
        _assert_costs_equal(exp, type(got)(
            *(None if t is None else t[b]
              for t in (got.sad, got.satd, got.min_sad_had, got.valid))),
            f"batch frame {b}")


def test_class_subsets_write_their_columns_and_union_to_compute_ext():
    """The latency engine's unit of work: the ``_columns`` of a partition
    of the classes cover the strided layout once, and each subset's
    ``_run_classes`` outputs, taken at its columns, together equal
    compute_ext (minSadHad through ``_combine``)."""
    width, height = 128, 128
    frame = torch.from_numpy(_frames(width, height, seed=4)[0][None])
    halo = frame[:, 0]
    want = tce.compute_ext(frame, frame, halo, True, width, height)
    s = tce.STRIDED_DISTORTIONS_PER_CTU
    assert tce._columns(width, height, (0, 16)) == [
        slice(int(s[0]), int(s[1])), slice(int(s[46]), int(s[47]))]
    covered = torch.zeros(tce.PER_CTU, dtype=torch.int32)
    got = [torch.full_like(want[0], -1) for _ in range(2)]
    for classes in ((0, 16), tuple(range(1, 16))):
        outs = tce._run_classes(frame, frame, halo, True, width, height,
                                False, classes)
        for c in tce._columns(width, height, classes):
            covered[c] += 1
            for g, out in zip(got, outs):
                g[..., c] = out[..., c]
    assert bool((covered == 1).all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(tce._combine(*got), want[2])


def test_cpu_path_launches_no_kernel():
    for k in KERNELS:
        k.launches = 0
    eng = tce.MipCostEngine(128, 128, device="cpu")
    eng.compute_batch(np.zeros((2, 128, 128), np.int32))
    assert [k.launches for k in KERNELS] == [0, 0, 0]
