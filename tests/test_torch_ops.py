"""The port's plain ops (vvc_mip_gpu_tpu_torch.ops) against the JAX
package's SoA ops, one shape class at a time, bit for bit.

Inputs are made with numpy from a seed and handed to both packages; the
tolerance is zero (every value is an integer).  Each class runs both
boundary regimes: the frame's top slab (``is_top``) and an inner slab with
a distinct halo row.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vvc_mip_gpu_tpu.models import cost_engine as jce
from vvc_mip_gpu_tpu.ops import geometry as jgeo
from vvc_mip_gpu_tpu.ops import mip_ops_soa as soa
from vvc_mip_gpu_tpu_torch.constants import num_ctus
from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, class_runs
from vvc_mip_gpu_tpu_torch.ops import geometry as tgeo
from vvc_mip_gpu_tpu_torch.ops import mip_ops as tops

W, H = 256, 128
N_CLASSES = 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and idle OpenMP threads would spin on cores the JAX tests use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b, what):
    a = np.asarray(a).astype(np.int64)
    b = b.cpu().numpy().astype(np.int64) if torch.is_tensor(b) else b
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    bad = a != b
    assert not bad.any(), (
        f"{what}: {bad.sum()} mismatches at {np.argwhere(bad)[:5]}")


def _inputs(seed):
    """A distortion-target frame, a distinct boundary source and a halo
    row, plus their padded slabs (the JAX engine's construction)."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 1024, (H, W)).astype(np.int16)
    ref = rng.integers(0, 1024, (H, W)).astype(np.int16)
    halo = rng.integers(0, 1024, (W,)).astype(np.int16)
    hp, wp = jgeo.padded_extent(W, H)
    frame_pad = np.pad(frame, ((0, hp - H), (0, wp - W)), mode="edge")
    ref_pad_f = np.pad(ref, ((0, hp - H), (0, wp - W)), mode="edge")
    halo_pad = np.pad(halo, (0, wp - W), mode="edge")
    ref_ext = np.concatenate([halo_pad[None], ref_pad_f], 0)
    ref_pad = np.concatenate([ref_ext[:, :1], ref_ext], 1)
    return frame, ref, halo, frame_pad, ref_pad


def test_geometry_matches_jax():
    for jp, tp in zip(jgeo.class_plans(W, H), tgeo.class_plans(W, H)):
        for jg, tg in zip(jp.groups, tp.groups):
            assert (jg.group_index, jg.y_prog, jg.x_prog) == (
                tg.group_index, tg.y_prog, tg.x_prog)
            np.testing.assert_array_equal(jg.ys, tg.ys)
            np.testing.assert_array_equal(jg.xs, tg.xs)
            np.testing.assert_array_equal(jg.valid, tg.valid)
    assert jgeo.padded_extent(W, H) == tgeo.padded_extent(W, H)
    assert jgeo.padded_extent(608, 192) == tgeo.padded_extent(608, 192)


def _jax_chain(frame_pad, ref_pad, is_top, ci):
    """The JAX SoA ops of one class, every stage's output kept."""
    plan = jgeo.class_plans(W, H)[ci]
    shape = plan.shape
    w, h, r, bs = (shape.width, shape.height, shape.reduced_pred_size,
                   shape.boundary_size)
    out = {"ref_t": [], "ref_l": [], "orig": []}
    for gp in plan.groups:
        t, lft = soa.gather_boundaries(ref_pad, gp, is_top)
        out["ref_t"].append(t)
        out["ref_l"].append(lft)
        out["orig"].append(soa.gather_originals(frame_pad, gp))
    ref_t, ref_l, orig = (jnp.concatenate(out[k], -1)
                          for k in ("ref_t", "ref_l", "orig"))
    out["red_t"] = soa.reduce_boundary(ref_t, bs)
    out["red_l"] = soa.reduce_boundary(ref_l, bs)
    pred = soa.reduced_prediction_all_modes(out["red_t"], out["red_l"],
                                            shape.size_id)
    out["pred"] = pred
    if shape.size_id > 0:
        pred = out["upsample"] = soa.upsample_all(pred, ref_t, ref_l, w, h,
                                                  r)
    out["sad"], out["satd"] = soa.distortion(orig, pred, h, w)
    return out


def _jax_class(frame_pad, ref_pad, is_top, ci):
    """Everything the tests compare for one class: the stage-by-stage
    chain and the engine's XLA class path in both output regimes."""
    plan = jgeo.class_plans(W, H)[ci]
    return {"chain": _jax_chain(frame_pad, ref_pad, is_top, ci),
            "msh": jce._class_costs(frame_pad, ref_pad, is_top, plan,
                                    use_pallas=False, max_performance=True),
            "sad_satd": jce._class_costs(frame_pad, ref_pad, is_top, plan,
                                         use_pallas=False,
                                         max_performance=False)}


# one compile per class (is_top is traced), shared by both tests below
_jax_class_jit = jax.jit(_jax_class, static_argnums=3)


@functools.cache
def _reference(ci, is_top):
    *_, frame_pad, ref_pad = _inputs(seed=100 + ci)
    return jax.device_get(_jax_class_jit(jnp.asarray(frame_pad),
                                         jnp.asarray(ref_pad),
                                         jnp.asarray(is_top), ci))


@pytest.mark.parametrize("ci", range(N_CLASSES))
def test_class_ops_match_jax(ci):
    """gather_boundaries, gather_originals, reduce_boundary,
    reduced_prediction_all_modes, upsample_all and distortion of one class
    against mip_ops_soa, stage by stage."""
    _, _, _, frame_pad, ref_pad = _inputs(seed=100 + ci)
    tplan = tgeo.class_plans(W, H)[ci]
    shape = tplan.shape
    w, h, r, bs = (shape.width, shape.height, shape.reduced_pred_size,
                   shape.boundary_size)
    for is_top in (True, False):
        exp = _reference(ci, is_top)["chain"]
        for k, tg in enumerate(tplan.groups):
            tt, tl = tops.gather_boundaries(torch.from_numpy(ref_pad), tg,
                                            is_top)
            _eq(exp["ref_t"][k], tt, f"ref_t g{tg.group_index}")
            _eq(exp["ref_l"][k], tl, f"ref_l g{tg.group_index}")
            to = tops.gather_originals(torch.from_numpy(frame_pad), tg)
            _eq(exp["orig"][k], to, f"orig g{tg.group_index}")
        ref_t, ref_l = (torch.from_numpy(np.concatenate(
            [np.asarray(a) for a in exp[k]], -1)) for k in ("ref_t", "ref_l"))
        orig = torch.from_numpy(np.concatenate(
            [np.asarray(a) for a in exp["orig"]], -1))
        red_t = tops.reduce_boundary(ref_t, bs)
        red_l = tops.reduce_boundary(ref_l, bs)
        _eq(exp["red_t"], red_t, "red_t")
        _eq(exp["red_l"], red_l, "red_l")
        pred = tops.reduced_prediction_all_modes(red_t, red_l,
                                                 shape.size_id)
        _eq(exp["pred"], pred, "pred")
        if shape.size_id > 0:
            pred = tops.upsample_all(pred, ref_t, ref_l, w, h, r)
            _eq(exp["upsample"], pred, "upsample")
        tsad, tsatd = tops.distortion(orig, pred, h, w)
        _eq(exp["sad"], tsad, "sad")
        _eq(exp["satd"], tsatd, "satd")


@pytest.mark.parametrize("ci", range(N_CLASSES))
def test_plain_class_costs_match_jax(ci):
    """Each class's plain cost function (the cost kernels' plain version)
    against the JAX engine's XLA class path, both regimes, every group's
    slice of the strided layout."""
    frame, ref, halo, _, _ = _inputs(seed=100 + ci)
    run = class_runs(W, H, torch.device("cpu"))[ci]
    n_ctu = num_ctus(W, H)[2]
    t = [torch.from_numpy(a[None]) for a in (frame, ref, halo)]
    for is_top, mp in ((True, True), (False, False), (False, True)):
        outs = [torch.full((1, n_ctu, PER_CTU), -1, dtype=torch.int32)
                for _ in range(1 if mp else 2)]
        run.kernel.plain(t[0], t[1], t[2], is_top, run.plan, run.table,
                         run.weights, outs)
        blocks = _reference(ci, is_top)["msh" if mp else "sad_satd"]
        for gi, blk in blocks.items():
            lo, hi = (int(v) for v in
                      jce.STRIDED_DISTORTIONS_PER_CTU[gi:gi + 2])
            for j, part in enumerate((blk,) if mp else blk):
                _eq(part, outs[j][0, :, lo:hi], f"group {gi} out {j}")
