"""The port's golden cost oracles (golden/reference_model.py,
golden/scalar_oracle.py) on the CPU: each equal to the JAX package's copy
(whole arrays, tolerance 0), the two equal to each other on sampled CUs of
every group, and the port's plain path equal to the port's golden model
on every valid CU at 160x184, whose bottom CTU row is 56 rows tall as at
1920x1080 (whole 416x240 frames: test_torch_golden_416x240.py).  NumPy
only on the JAX side: no JAX compile."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu.golden import reference_model as jgm
from vvc_mip_gpu_tpu.golden import scalar_oracle as jso
from vvc_mip_gpu_tpu_torch.constants import GROUPS
from vvc_mip_gpu_tpu_torch.golden import reference_model as gm
from vvc_mip_gpu_tpu_torch.golden import scalar_oracle as so
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine

GOLDEN_DIR = Path(gm.__file__).resolve().parent
FIELDS = ("sad", "satd", "min_sad_had")
# 160x184: a partial right CTU column of 32 and a partial bottom CTU row
# of 56 (1080 = 8 * 128 + 56)
W, H = 160, 184


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed: int, width: int, height: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1024, (height, width))


FRAME = _frame(31, W, H)
REF = _frame(32, W, H)  # a distinct reference: the alternative regime


@pytest.fixture(scope="module")
def port_costs():
    """The port's golden model at 160x184 in both regimes, computed once
    (the golden model takes ~0.8 s a CTU here)."""
    return {"original": gm.frame_costs(FRAME),
            "distinct ref": gm.frame_costs(FRAME, REF)}


def _assert_same(mine, theirs):
    assert sorted(mine) == sorted(theirs) == list(range(len(GROUPS)))
    for g in GROUPS:
        for field in (*FIELDS, "valid"):
            a = getattr(mine[g.index], field)
            b = getattr(theirs[g.index], field)
            assert a.dtype == b.dtype, (g.name, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{g.name} {field}")
    for field in FIELDS:
        np.testing.assert_array_equal(gm.flatten_strided(mine, field),
                                      jgm.flatten_strided(theirs, field),
                                      err_msg=field)


def test_golden_equals_jax_golden_128x128_original_samples():
    frame = _frame(30, 128, 128)
    _assert_same(gm.frame_costs(frame), jgm.frame_costs(frame))


def test_golden_equals_jax_golden_160x184_distinct_ref(port_costs):
    """Whole arrays, out-of-frame CUs included: both clip their
    coordinates the same way."""
    _assert_same(port_costs["distinct ref"], jgm.frame_costs(FRAME, REF))


@pytest.mark.parametrize("group_idx", range(len(GROUPS)))
def test_scalar_oracle_vs_jax_oracle_and_golden(port_costs, group_idx):
    """Three valid CUs of the group (in the partial CTUs where the group
    has any there), a random mode each: the port's scalar oracle equals
    the JAX one and the port's golden model."""
    g = GROUPS[group_idx]
    gc = port_costs["distinct ref"][group_idx]
    xs, ys = gm.global_positions(group_idx, W, H)
    assert xs.shape == gc.valid.shape
    cand = np.argwhere(gc.valid)
    partial = cand[(xs[tuple(cand.T)] >= 128) | (ys[tuple(cand.T)] >= 128)]
    rng = np.random.default_rng(100 + group_idx)
    picks = [cand[rng.integers(len(cand))] for _ in range(2)]
    picks.append(partial[rng.integers(len(partial))] if len(partial)
                 else cand[rng.integers(len(cand))])
    for ctu, cu in picks:
        mode = int(rng.integers(g.total_modes))
        x, y = int(xs[ctu, cu]), int(ys[ctu, cu])
        args = (FRAME, REF, x, y, g.width, g.height, g.size_id, mode)
        got = so.cu_cost(*args)
        assert got == jso.cu_cost(*args), (ctu, cu, mode)
        assert got == (gc.sad[ctu, cu, mode], gc.satd[ctu, cu, mode],
                       gc.min_sad_had[ctu, cu, mode]), (ctu, cu, mode)


def test_scalar_oracle_edge_padding_rules():
    """Top-left corner CU uses DC boundaries; top edge uses left-sample
    padding; left edge uses top-sample padding; the golden model's
    boundaries follow the same rules."""
    assert so.top_boundary(FRAME, 0, 0, 8) == [512] * 8
    assert so.left_boundary(FRAME, 0, 0, 8) == [512] * 8
    assert so.top_boundary(FRAME, 64, 0, 8) == [int(FRAME[0, 63])] * 8
    assert so.left_boundary(FRAME, 0, 64, 8) == [int(FRAME[63, 0])] * 8
    for x, y in ((0, 0), (64, 0), (0, 64), (40, 36)):
        assert so.top_boundary(FRAME, x, y, 8) == jso.top_boundary(
            FRAME, x, y, 8)
        assert so.left_boundary(FRAME, x, y, 8) == jso.left_boundary(
            FRAME, x, y, 8)
    rt, rl = gm.extract_boundaries(FRAME, np.array([0, 64, 0]),
                                   np.array([0, 0, 64]), 8, 8)
    np.testing.assert_array_equal(rt[0], [512] * 8)
    np.testing.assert_array_equal(rt[1], [int(FRAME[0, 63])] * 8)
    np.testing.assert_array_equal(rl[2], [int(FRAME[63, 0])] * 8)


def test_scalar_oracle_satd_known_values():
    z = [[0] * 4] * 4
    assert so.satd_4x4(z, z) == 0
    # a uniform difference of 1: only the DC coefficient (16) is nonzero,
    # (16 - 16 + (16 >> 2) + 1) >> 1 = 2
    assert so.satd_4x4([[1] * 4] * 4, z) == 2
    # one sample differing by 5: |t| = 5 at all 16 coefficients,
    # (80 - 5 + (5 >> 2) + 1) >> 1 = 38
    imp = [[5 if (i, j) == (0, 0) else 0 for j in range(4)] for i in range(4)]
    assert so.satd_4x4(imp, z) == 38


@pytest.mark.parametrize("max_performance", [True, False],
                         ids=["max-performance", "full report"])
@pytest.mark.parametrize("regime", ["original", "distinct ref"])
def test_plain_path_equals_golden_160x184(port_costs, regime,
                                          max_performance):
    """The port's plain path against its golden model on every valid CU,
    and its validity mask against the golden model's per-group masks (the
    port fills out-of-frame CUs from edge replication, the golden model
    from clipped coordinates, so only valid CUs compare)."""
    engine = MipCostEngine(W, H, max_performance=max_performance,
                           device="cpu")
    got = engine(FRAME, None if regime == "original" else REF)
    _assert_equal_on_valid_cus(got, port_costs[regime],
                               ("min_sad_had",) if max_performance
                               else FIELDS)
    if max_performance:
        assert got.sad is None and got.satd is None


def _assert_equal_on_valid_cus(got, exp, fields):
    """``got`` (one frame's FrameCosts) equals the golden model's ``exp``
    on every valid CU, and its validity mask the golden model's
    per-group masks."""
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.concatenate(
        [np.repeat(exp[g.index].valid, g.total_modes, axis=1)
         for g in GROUPS], axis=1))
    assert 0 < valid.sum() < valid.size
    for field in fields:
        a = getattr(got, field).numpy().astype(np.int64)
        mism = (a != gm.flatten_strided(exp, field)) & valid
        assert not mism.any(), (
            f"{field}: {mism.sum()} mismatches at {np.argwhere(mism)[:5]}")


def test_golden_imports_only_constants_and_weights_of_the_port():
    """The oracles take the port's constants and weights and nothing else
    of it (no ops/, models/, parallel/, kernels), nor anything of JAX."""
    allowed = {"vvc_mip_gpu_tpu_torch.constants",
               "vvc_mip_gpu_tpu_torch.mip_weights"}
    for path in sorted(GOLDEN_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, (path.name, "relative import")
                names = ([f"{node.module}.{a.name}" for a in node.names]
                         if node.module == "vvc_mip_gpu_tpu_torch"
                         else [node.module or ""])
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "vvc_mip_gpu_tpu"), (
                    path.name, name)
                if top == "vvc_mip_gpu_tpu_torch":
                    assert name in allowed, (path.name, name)
