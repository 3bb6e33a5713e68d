"""The port's CPU filtering oracle and profiler (golden/filters_golden.py,
tools/profile_cpu_filtering.py), its in-context class profiler
(tools/profile_incontext.py) and its example-frame writer
(tools/make_example_frames.py), on the CPU: the golden copy bit for bit
against the JAX package's golden model and the port's torch filters, the
band decomposition against the whole frame, each class alone against the
whole search, and the frame CSVs against the JAX tool's bytes."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu.golden import filters_golden as jfg
from vvc_mip_gpu_tpu_torch.constants import (
    AVAILABLE_FILTERS,
    STRIDED_DISTORTIONS_PER_CTU,
)
from vvc_mip_gpu_tpu_torch.golden import filters_golden as tfg
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models import cost_engine as tce
from vvc_mip_gpu_tpu_torch.ops import filters as tf
from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans
from vvc_mip_gpu_tpu_torch.tools import (
    make_example_frames,
    profile_cpu_filtering,
    profile_incontext,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import make_example_frames as jax_make_example_frames  # noqa: E402

# the variants of the JAX tool's band test (tests/test_energy_tools.py)
BANDED = ("filterFrame_2d_int_quarterCtu",
          "filterFrame_2d_float_5x5_quarterCtu",
          "filterFrame_1d_int",
          "filterFrame_1d_float_5x5")
SIZE = 128  # the in-context profiler's frame: one CTU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ftype", AVAILABLE_FILTERS)
def test_golden_copy_matches_jax_golden_and_port_filters(ftype):
    """All 8 variants x every KernelIdx, on a noise and a smooth 36x52
    frame (every edge and corner divisor rule), tolerance 0."""
    rng = np.random.default_rng(21)
    frames = (rng.integers(0, 1024, (36, 52)),
              synthetic_frames(1, 52, 36, seed=3)[0].astype(np.int64))
    for kidx in range(3 if "5x5" in ftype else 5):
        for frame in frames:
            got = tfg.filter_frame(frame, ftype, kidx)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(
                got, jfg.filter_frame(frame, ftype, kidx),
                err_msg=f"{ftype}[{kidx}] vs the JAX golden model")
            np.testing.assert_array_equal(
                got, tf.filter_frame(frame, ftype, kidx).numpy(),
                err_msg=f"{ftype}[{kidx}] vs the port's filters")


@pytest.mark.parametrize("ftype", BANDED)
def test_banded_filter_matches_whole_frame(ftype):
    frame = np.random.default_rng(5).integers(
        0, 1024, size=(96, 128)).astype(np.int64)
    ref = tfg.filter_frame(frame, ftype, 0)
    for n in (2, 3, 7):
        np.testing.assert_array_equal(
            profile_cpu_filtering.filter_banded(frame, ftype, 0, n), ref,
            err_msg=f"{ftype}/{n}")


def test_cpu_filtering_profiler_prints_one_row_per_variant(capsys,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = profile_cpu_filtering.main(["-s", "64x48", "--max-workers", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"host: {profile_cpu_filtering.host_cpus()} CPUs; "
                      f"card: no CUDA card present")
    rows = [line for line in out if line.startswith("filterFrame_")]
    assert [row.split()[0] for row in rows] == list(
        profile_cpu_filtering.VARIANTS)
    assert all(len(row.split()) == 1 + 3 for row in rows)  # 1, 2, 4 workers
    assert list(table) == list(profile_cpu_filtering.VARIANTS)
    assert all(list(t) == [1, 2, 4] for t in table.values())


class _SentinelTorch:
    """cost_engine's ``torch`` with ``empty`` filling -1, so an entry no
    kernel writes shows."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(size, **kwargs):
        return torch.full(size, -1, **kwargs)


def test_each_class_alone_writes_exactly_its_blocks(monkeypatch):
    """profile_incontext's unit of work, one class at a time: the columns
    of the class's groups equal the same columns of the whole search, the
    engine's ``_columns`` name exactly those, and every other entry of the
    output is left unwritten."""
    monkeypatch.setattr(tce, "torch", _SentinelTorch())
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1024, size=(1, SIZE, SIZE), dtype=np.int32))
    whole = profile_incontext.blocks_of(frames)
    assert whole.shape[-1] == int(STRIDED_DISTORTIONS_PER_CTU[-1])
    assert int(whole.min()) >= 0  # the whole search writes everything
    for i, cplan in enumerate(class_plans(SIZE, SIZE)):
        got = profile_incontext.blocks_of(frames, (i,))
        mask = torch.zeros(whole.shape[-1], dtype=torch.bool)
        for gp in cplan.groups:
            mask[int(STRIDED_DISTORTIONS_PER_CTU[gp.group_index]):
                 int(STRIDED_DISTORTIONS_PER_CTU[gp.group_index + 1])] = True
        columns = torch.zeros_like(mask)
        for c in tce._columns(SIZE, SIZE, (i,)):
            columns[c] = True
        assert torch.equal(columns, mask), i
        assert torch.equal(got[..., mask], whole[..., mask]), i
        assert bool((got[..., ~mask] == -1).all()), i


def test_incontext_sweep_on_the_cpu(monkeypatch, capsys):
    """e2e, the 17 classes alone and their sum, each line naming the
    device; the plain path launches no kernel."""
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    recs = profile_incontext.profile(SIZE, SIZE, torch.device("cpu"),
                                     repeats=1, iters=1)
    lines = capsys.readouterr().out.splitlines()
    names = [f"{cp.shape.width}x{cp.shape.height}"
             for cp in class_plans(SIZE, SIZE)]
    assert [r["what"] for r in recs] == ["e2e"] + ["alone"] * 17 + ["sum"]
    assert [r["class"] for r in recs[1:18]] == names
    assert len(lines) == len(recs)
    assert all(line.endswith("(cpu)") for line in lines)
    assert all(r["launches"] == [0, 0, 0] for r in recs[:18])
    assert recs[-1]["ms"] == pytest.approx(sum(r["ms"] for r in recs[1:18]))
    assert all(r["ms"] > 0 for r in recs)


def test_incontext_leave_one_out_and_batch(monkeypatch, capsys):
    """--loo adds one line per class left out, with its delta against the
    e2e; --batch N times N frames (the whole sweep with --loo); --class
    one class.  Each line: 1 + ITERS untimed calls, REPEATS x ITERS
    timed."""
    seen = []
    monkeypatch.setattr(profile_incontext, "blocks_of",
                        lambda frames, classes=None: seen.append(
                            (frames.shape[0], classes)))
    recs = profile_incontext.profile(SIZE, SIZE, torch.device("cpu"),
                                     loo=True, repeats=2, iters=3)
    without = [r for r in recs if r["what"] == "without"]
    assert len(without) == 17
    for i, r in enumerate(without):
        assert r["delta_ms"] == recs[0]["ms"] - r["ms"]
    # each class left out once, each line 1 + 3 untimed + 2 x 3 timed
    loo_calls = [c for _, c in seen if c is not None and len(c) == 16]
    assert sorted(loo_calls) == sorted(
        tuple(j for j in range(17) if j != i) for i in range(17)
        for _ in range(10))
    assert len(seen) == 10 * (1 + 17 + 17)
    seen.clear()
    recs = profile_incontext.profile(SIZE, SIZE, torch.device("cpu"),
                                     batch=4, repeats=1, iters=1)
    assert [(r["what"], r["frames"]) for r in recs] == [("e2e", 4)]
    assert recs[0]["ms_per_frame"] == recs[0]["ms"] / 4
    assert seen == [(4, None)] * 3
    seen.clear()
    recs = profile_incontext.profile(SIZE, SIZE, torch.device("cpu"),
                                     batch=2, loo=True, repeats=1, iters=1)
    assert [r["what"] for r in recs] == (["e2e"] + ["alone"] * 17 + ["sum"]
                                         + ["without"] * 17)
    assert {r["frames"] for r in recs} == {2}
    assert {f for f, _ in seen} == {2}
    seen.clear()
    recs = profile_incontext.profile(SIZE, SIZE, torch.device("cpu"),
                                     batch=2, only="8x8", repeats=1, iters=1)
    assert [(r["what"], r["class"]) for r in recs] == [("alone", "8x8")]
    assert seen == [(2, (13,))] * 3
    with pytest.raises(ValueError, match="no class"):
        profile_incontext.profile(SIZE, SIZE, torch.device("cpu"),
                                  only="2x2")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("e2e (max-perf)")
    assert "delta" in lines[19]


def test_incontext_refuses_ablate(capsys):
    with pytest.raises(SystemExit):
        profile_incontext.main(["--ablate"])
    assert "no counterpart in the port" in capsys.readouterr().err


def test_incontext_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("VVC_MIP_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profile_incontext, "profile", lambda *a, **k: (
        pytest.fail("profiled without a card")))
    with pytest.raises(RuntimeError, match="VVC_MIP_PLATFORM=cpu"):
        profile_incontext.main([])


def test_make_example_frames_matches_the_jax_tool(tmp_path, monkeypatch,
                                                  capsys):
    args = ["--resolution", "24x16", "--frames", "3", "--seed", "7"]
    mine, theirs = tmp_path / "port" / "f.csv", tmp_path / "jax" / "f.csv"
    make_example_frames.main([str(mine), *args])
    monkeypatch.setattr(sys, "argv", ["make_example_frames", str(theirs),
                                      *args])
    jax_make_example_frames.main()
    assert mine.read_bytes() == theirs.read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(mine), "X") == out[1].replace(str(theirs), "X")
