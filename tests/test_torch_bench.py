"""The port's bench (``python -m vvc_mip_gpu_tpu_torch.bench``) on the CPU:
one JSON line in each mode with ``bench.py``'s metric name for the same
flags, the compute window's frames and checksum, and the entry point's
exit codes with and without a device."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu_torch import bench
from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, MipCostEngine

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--resolution", "128x64", "--batch", "1", "--iters", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bench():
    """The repository's bench.py as a module (importing it loads JAX and
    compiles nothing)."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_record(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert len(lines) == 1, text
    return json.loads(lines[0])


@pytest.mark.parametrize("extra, fields", [
    ([], {"device_ms_per_batch"}),
    (["--filtered"], {"device_ms_per_batch"}),
    (["--window", "reference"], {"pipeline", "decomposition_per_batch"}),
    (["--window", "r1"], set()),
    (["--with-export"], {"export"}),
    (["--latency"], {"decomposition"}),
], ids=["compute", "filtered", "reference", "r1", "with-export", "latency"])
def test_bench_prints_one_json_line(extra, fields, jax_bench, monkeypatch,
                                    capsys):
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    assert bench.main(SMALL + extra) == 0
    rec = _one_record(capsys.readouterr().out)
    assert set(rec) >= {"metric", "value", "unit", "vs_baseline", "device",
                        "launches", *fields}
    assert "error" not in rec
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["device"] == "cpu"
    assert rec["unit"] == ("ms" if "--latency" in extra else "frames/s")
    # the plain path on the CPU: no kernel launched
    assert set(rec["launches"].values()) == {0}
    monkeypatch.setattr(sys, "argv", ["bench.py", *SMALL, *extra])
    assert rec["metric"] == jax_bench._metric_from_argv()
    if "--window" in extra and "reference" in extra:
        assert rec["decomposition_per_batch"]["read_bytes"] == PER_CTU * 4
        assert rec["decomposition_per_batch"]["upload_bytes"] == 128 * 64 * 2
    if "--with-export" in extra:
        assert rec["export"]["frames"] == 1
        assert rec["export"]["csv_bytes"] > 0
    if "--latency" in extra:
        assert rec["decomposition"]["n_devices"] == 1


def test_bench_failure_is_one_error_record(monkeypatch, capsys):
    """A failure inside a run prints the error record and returns 1; the
    bench does not retry or fall back."""
    def broken(*args, **kwargs):
        raise RuntimeError("no kernel")

    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    monkeypatch.setattr(bench, "MipCostEngine", broken)
    assert bench.main(SMALL + ["--filtered"]) == 1
    rec = _one_record(capsys.readouterr().out)
    assert rec["metric"] == "mip_search_128x64_filtered_frames_per_second"
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert rec["error"] == "RuntimeError: no kernel"


def test_compute_window_frames_and_checksum():
    """The window's batches follow frames[i % B] ^ ((salt + i) & 1023)
    over the whole window (the salt wraps at 1024) and stay 10-bit; its
    count equals the nonzero minSadHad entries of those frames, each
    searched on its own."""
    b, iters, salt = 2, 2, 1021
    frames_np = np.random.default_rng(5).integers(0, 1024, (b, 64, 128),
                                                  dtype=np.int32)
    frames_np[1] = 512  # flat: costs of 0 among them
    frames = torch.from_numpy(frames_np)
    want = np.stack([frames_np[i % b] ^ ((salt + i) & 1023)
                     for i in range(b * iters)])
    out = torch.empty_like(frames)
    got = np.concatenate([x.numpy().copy() for x in bench.salted_batches(
        frames, salt, iters, out)])
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 1023
    engine = MipCostEngine(128, 64, max_performance=True, device="cpu")
    acc = bench.count_window(bench.searcher(engine, False), frames, salt,
                             iters, out)
    assert acc.dtype == torch.int64
    counts = [int(np.count_nonzero(engine(f).min_sad_had.numpy()))
              for f in want]
    assert min(counts) < PER_CTU  # the flat frames count fewer
    assert int(acc) == sum(counts)


def _run_module(env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "vvc_mip_gpu_tpu_torch.bench", *SMALL,
         "--window", "r1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_module_runs_on_the_cpu_when_asked():
    env = dict(os.environ, VVC_MIP_PLATFORM="cpu", OMP_NUM_THREADS="1")
    r = _run_module(env)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = _one_record(r.stdout)
    assert rec["value"] > 0 and rec["device"] == "cpu"


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="needs a machine without a CUDA device")
def test_module_without_a_card_exits_nonzero():
    env = {k: v for k, v in os.environ.items() if k != "VVC_MIP_PLATFORM"}
    env["OMP_NUM_THREADS"] = "1"
    r = _run_module(env)
    assert r.returncode != 0
    rec = _one_record(r.stdout)
    assert rec["value"] is None
    assert "no CUDA device" in rec["error"]
