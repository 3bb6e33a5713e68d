"""The port's plain 4x4 and 64x64 classes against the JAX engine on
saturated content, bit for bit.

A 0/1023 checkerboard at 128x128 drives the prediction clamp at both ends
and the largest differences and SATDs.  The port's plain class function
(the CUDA kernels' plain version, which ``tests/test_torch_kernels.py``
holds the kernels against on the card on the same kind of frames) is
compared with the JAX engine's XLA class path, ``_class_costs``, in both
output regimes, at the frame top and as an inner slab under a saturated
halo row.  One JAX compile per class; inputs made with numpy.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vvc_mip_gpu_tpu.models import cost_engine as jce
from vvc_mip_gpu_tpu.ops import geometry as jgeo
from vvc_mip_gpu_tpu_torch.constants import num_ctus
from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, class_runs

W = H = 128
SHAPES = [(4, 4), (64, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _class_index(shape) -> int:
    return next(i for i, p in enumerate(jgeo.class_plans(W, H))
                if (p.shape.width, p.shape.height) == shape)


def _frames():
    """The checkerboard, and a halo row of its complement."""
    yy, xx = np.mgrid[:H, :W]
    frame = ((yy + xx) % 2 * 1023).astype(np.int16)
    return frame, (1023 - frame[0]).astype(np.int16)


def _jax_class(frame_pad, ref_pad, is_top, ci):
    plan = jgeo.class_plans(W, H)[ci]
    return {mp: jce._class_costs(frame_pad, ref_pad, is_top, plan,
                                 use_pallas=False, max_performance=mp)
            for mp in (True, False)}


_jax_class_jit = jax.jit(_jax_class, static_argnums=3)


@functools.cache
def _reference(ci, is_top):
    frame, halo = _frames()
    hp, wp = jgeo.padded_extent(W, H)
    frame_pad = np.pad(frame, ((0, hp - H), (0, wp - W)), mode="edge")
    halo_pad = np.pad(halo, (0, wp - W), mode="edge")
    ref_ext = np.concatenate([halo_pad[None], frame_pad], 0)
    ref_pad = np.concatenate([ref_ext[:, :1], ref_ext], 1)
    return jax.device_get(_jax_class_jit(jnp.asarray(frame_pad),
                                         jnp.asarray(ref_pad),
                                         jnp.asarray(is_top), ci))


@pytest.mark.parametrize("is_top", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_class_matches_jax_on_checkerboard(shape, is_top):
    ci = _class_index(shape)
    frame, halo = _frames()
    run = class_runs(W, H, torch.device("cpu"))[ci]
    assert (run.plan.shape.width, run.plan.shape.height) == shape
    f, hrow = torch.from_numpy(frame[None]), torch.from_numpy(halo[None])
    n_ctu = num_ctus(W, H)[2]
    for mp in (True, False):
        outs = [torch.full((1, n_ctu, PER_CTU), -1, dtype=torch.int32)
                for _ in range(1 if mp else 2)]
        run.kernel.plain(f, f, hrow, is_top, run.plan, run.table,
                         run.weights, outs)
        blocks = _reference(ci, is_top)[mp]
        assert blocks, "no JAX blocks"
        for gi, blk in blocks.items():
            lo, hi = (int(v) for v in
                      jce.STRIDED_DISTORTIONS_PER_CTU[gi:gi + 2])
            for j, part in enumerate((blk,) if mp else blk):
                want = np.asarray(part).astype(np.int64)
                got = outs[j][0, :, lo:hi].numpy().astype(np.int64)
                assert want.shape == got.shape
                bad = want != got
                assert not bad.any(), (
                    f"{shape} mp={mp} group {gi} out {j}: {bad.sum()} "
                    f"entries differ")
