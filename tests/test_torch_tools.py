"""The port's measurement tools (vvc_mip_gpu_tpu_torch.tools): the energy
analysis against the JAX package's tools/compute_energy.py, the roofline's
op model against tools/roofline.py, the power tracer on the port's CLI
with a stand-in meter (and a meter that fails), and the scaling report on
the CPU."""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from vvc_mip_gpu_tpu.constants import num_ctus, shape_classes
from vvc_mip_gpu_tpu_torch.tools import (
    compute_energy,
    power_tracer,
    roofline,
    scaling_report,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import compute_energy as jax_compute_energy  # noqa: E402
import roofline as jax_roofline  # noqa: E402
from test_energy_tools import MARKERS, POWER  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_energy_analysis_matches_the_jax_tool():
    assert compute_energy.parse_markers(MARKERS) == \
        jax_compute_energy.parse_markers(MARKERS)
    assert compute_energy.parse_power(POWER) == \
        jax_compute_energy.parse_power(POWER)
    assert compute_energy.analyze(MARKERS, POWER) == \
        jax_compute_energy.analyze(MARKERS, POWER)
    # the CLI's compact report adds the energy per frame
    report = compute_energy.analyze(
        MARKERS + ["TotalElapsedMs,4000.00,frames,2,fps,0.500"], POWER)
    assert report["frames"] == 2 and report["energy_per_frame_j"] == 80.0
    assert {k: v for k, v in report.items()
            if k not in ("frames", "energy_per_frame_j")} == \
        jax_compute_energy.analyze(MARKERS, POWER)


def test_op_model_matches_the_jax_roofline():
    n_ctus = num_ctus(1920, 1080)[2]
    work = roofline.class_work(1920, 1080, batch=1)
    assert len(work) == 17
    for cl, row in zip(shape_classes(), work):
        n_cu = cl.cus_per_ctu * n_ctus
        assert row["class"] == f"{cl.width}x{cl.height}"
        assert row["n_cu"] == n_cu
        want = jax_roofline.class_ops(cl.height, cl.width,
                                      cl.reduced_pred_size, cl.total_modes,
                                      n_cu)["ops"]
        assert row["ops"] == want == roofline.class_ops(
            cl.height, cl.width, cl.reduced_pred_size, cl.total_modes, n_cu)
    rep = roofline.report(1920, 1080, 16, 132, 1980.0)
    assert rep["bound_by"] == "operations"
    assert rep["int32_tops"] == 128 * 132 * 1980e6 / 1e12


def test_power_tracer_on_the_cli(tmp_path, monkeypatch, capsys):
    """One traced CLI run at 128x128 on the CPU with ``echo 123.4`` as the
    meter: a timestamp_s,power_w trace, paired stage markers, the energy
    per frame; then meters that fail or print nothing raise."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prefix = str(tmp_path / "p_")
    power_tracer.main(["-s", "128x128", "--max-frames", "1", "--power-cmd",
                       "echo 123.4", "--interval-ms", "50",
                       "--prefix", prefix])
    assert "completed nFrames=1" in capsys.readouterr().out
    trace = Path(prefix + "128x128_f1_power.csv").read_text().splitlines()
    assert trace[0] == "timestamp_s,power_w" and len(trace) > 1
    samples = compute_energy.parse_power(trace)
    assert {p for _, p in samples} == {123.4}
    assert [t for t, _ in samples] == sorted(t for t, _ in samples)
    log = Path(prefix + "128x128_f1_stdout.log").read_text().splitlines()
    starts = sorted(line.split(",")[0][6:] for line in log
                    if line.startswith("START "))
    finishes = sorted(line.split(",")[0][7:] for line in log
                      if line.startswith("FINISH "))
    assert starts == finishes and "ENQUEUE KERNELS" in starts
    report = compute_energy.analyze(log, trace)
    assert report["frames"] == 1
    assert report["energy_per_frame_j"] == pytest.approx(
        123.4 * report["active_window_s"])
    for cmd in ("exit 3", "true"):
        with pytest.raises(RuntimeError, match="gave no sample"):
            with power_tracer.PowerMeter(cmd, str(tmp_path / "bad.csv"),
                                         0.01):
                while not Path(tmp_path / "bad.csv").exists():
                    pass
                torch.zeros(1)


def test_scaling_report_on_the_cpu(monkeypatch):
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scaling_report.main(["-s", "256x128", "--batch", "2", "--iters", "1",
                             "--devices", "2"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["timing"] == "host clock"
    assert "CPU" in rep["devices"]
    assert [r["mesh"] for r in rep["rows"]] == [
        "1 device", "data=1 space=2", "data=2 space=1"]
    assert all(r["fps"] > 0 for r in rep["rows"])
    assert rep["rows"][0]["efficiency"] == 1.0
