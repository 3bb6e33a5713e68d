"""The port's I/O and CLI (vvc_mip_gpu_tpu_torch.io, .cli) against the JAX
package's: the frames CSV and every decisions-CSV variant byte for byte,
the best-mode decision, and one CLI run of each package on the same
synthetic frames (filtered regime, full report, target CTU) writing
byte-identical files.  Then the port's CLI alone: --OnlyFilter, --Resume,
a ragged tail chunk, and the device rules (CUDA unless
VVC_MIP_PLATFORM=cpu; the multi-device flags are refused)."""

import filecmp
import threading

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu import cli as jcli
from vvc_mip_gpu_tpu.golden import filters_golden as fg
from vvc_mip_gpu_tpu.io import export as jexport
from vvc_mip_gpu_tpu.io import frames as jframes
from vvc_mip_gpu_tpu_torch import cli as tcli
from vvc_mip_gpu_tpu_torch.io import export as texport
from vvc_mip_gpu_tpu_torch.io import frames as tframes
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.utils.pipeline import pipelined

PER_CTU = texport.DIST_PER_CTU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")


def _same(a, b):
    assert filecmp.cmp(a, b, shallow=False), f"{a} and {b} differ"


def test_frames_csv_roundtrip_and_bytes(tmp_path):
    fr = tframes.synthetic_frames(3, 64, 48)
    np.testing.assert_array_equal(fr, jframes.synthetic_frames(3, 64, 48))
    tframes.write_frames_csv(tmp_path / "t.csv", fr)
    jframes.write_frames_csv(tmp_path / "j.csv", fr)
    _same(tmp_path / "t.csv", tmp_path / "j.csv")
    back = tframes.read_frames_csv(tmp_path / "t.csv", 64, 48, 3)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, fr)
    np.testing.assert_array_equal(
        tframes.read_frames_csv(tmp_path / "t.csv", 64, 48, 2, start=1),
        fr[1:])
    assert tframes.read_frames_csv(tmp_path / "t.csv", 64, 48, 0).shape == (
        0, 48, 64)
    with pytest.raises(ValueError, match="expected"):
        tframes.read_frames_csv(tmp_path / "t.csv", 64, 48, 4)
    with pytest.raises(ValueError, match="expected"):
        tframes.read_frames_csv(tmp_path / "t.csv", 32, 96, 1)


def _costs(n_ctu, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 10 ** 6, (n_ctu, PER_CTU)) for _ in range(3)]


@pytest.mark.parametrize("variant", ["msh", "full", "poc", "satd_only",
                                     "negative"])
def test_decisions_csv_bytes(tmp_path, variant):
    msh, sad, satd = _costs(3, seed=len(variant))
    kwargs = {"msh": {}, "full": {"sad": sad, "satd": satd},
              "poc": {"sad": sad, "satd": satd, "poc": 12},
              "satd_only": {"satd": satd, "poc": 0},
              "negative": {"sad": -sad}}[variant]
    if variant == "negative":
        msh = msh - 500_000
    texport.export_decisions_csv(tmp_path / "t.csv", msh, 384, **kwargs)
    jexport.export_decisions_csv(tmp_path / "j.csv", msh, 384, **kwargs)
    _same(tmp_path / "t.csv", tmp_path / "j.csv")


def test_target_ctu_csv_bytes_and_best_modes(tmp_path):
    msh, sad, satd = _costs(2, seed=7)
    for kwargs in ({}, {"sad_per_frame": [sad[0], None],
                        "satd_per_frame": [satd[0], satd[1]],
                        "pocs": [4, 9]}):
        texport.export_target_ctu_csv(tmp_path / "t.csv", [msh[0], msh[1]],
                                      256, 1, **kwargs)
        jexport.export_target_ctu_csv(tmp_path / "j.csv", [msh[0], msh[1]],
                                      256, 1, **kwargs)
        _same(tmp_path / "t.csv", tmp_path / "j.csv")
    got, want = texport.decide_best_modes(msh), jexport.decide_best_modes(msh)
    assert sorted(got) == sorted(want)
    for g in want:
        for a, b in zip(got[g], want[g]):
            np.testing.assert_array_equal(a, b)


CLI_ARGS = ["-f", "2", "-s", "128x128", "--Synthetic", "--FullDistortion",
            "--FilterType", "filterFrame_1d_float_5x5", "--KernelIdx", "1",
            "--TargetCTU", "0"]


def _report_lines(text):
    """The CLI's stdout without file names and timings."""
    return [line for line in text.splitlines()
            if not line.startswith(("wrote ", "  ", "Stage timing",
                                    "TotalElapsedMs"))]


def test_cli_matches_the_jax_cli(tmp_path, on_cpu, capsys):
    assert jcli.main(CLI_ARGS + ["-l", str(tmp_path / "j_")]) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(CLI_ARGS + ["-l", str(tmp_path / "t_")]) == 0
    out = capsys.readouterr().out
    for name in ("mip_decisions_poc0.csv", "mip_decisions_poc1.csv",
                 "target_ctu0.csv"):
        _same(tmp_path / f"t_{name}", tmp_path / f"j_{name}")
    assert _report_lines(out) == _report_lines(jax_out)
    assert out.count("=== DISTORTION, CTU 0") == 2
    for stage in ("READ SAMPLES", "ENQUEUE FILTER", "ENQUEUE KERNELS",
                  "READ DISTORTION", "WRITE DECISIONS"):
        assert stage in out


def test_cli_only_filter(tmp_path, on_cpu):
    assert tcli.main(["-f", "2", "-s", "64x48", "--Synthetic",
                      "--FilterType", "filterFrame_2d_int_quarterCtu",
                      "--KernelIdx", "2", "--OnlyFilter",
                      "-l", str(tmp_path / "f_")]) == 0
    assert not list(tmp_path.glob("f_mip_decisions*"))
    got = tframes.read_frames_csv(tmp_path / "f_filtered.csv", 64, 48, 2)
    for b, frame in enumerate(tframes.synthetic_frames(2, 64, 48)):
        np.testing.assert_array_equal(
            got[b], fg.filter_frame(frame.astype(np.int64),
                                    "filterFrame_2d_int_quarterCtu", 2))


def test_cli_resume_and_ragged_tail(tmp_path, on_cpu, capsys):
    """3 frames in chunks of 2 (a 1-frame tail chunk); every frame's
    costs equal the engine's.  A rerun with --Resume after deleting frame
    1's log recomputes frame 1 only and leaves the others untouched."""
    args = ["-f", "3", "-s", "128x128", "--Synthetic", "--BatchFrames", "2",
            "-l", str(tmp_path / "r_")]
    assert tcli.main(args) == 0
    paths = [tmp_path / f"r_mip_decisions_poc{f}.csv" for f in range(3)]
    engine = MipCostEngine(128, 128, max_performance=True, device="cpu")
    costs = engine.compute_batch(tframes.synthetic_frames(3, 128, 128)
                                 .astype(np.int32)).min_sad_had.numpy()
    for f, path in enumerate(paths):
        texport.export_decisions_csv(tmp_path / "want.csv", costs[f], 128,
                                     poc=f)
        _same(path, tmp_path / "want.csv")
    first = [p.read_bytes() for p in paths]
    mtimes = [p.stat().st_mtime_ns for p in paths]
    paths[1].unlink()
    capsys.readouterr()
    assert tcli.main(args + ["--Resume"]) == 0
    out = capsys.readouterr().out
    assert out.count("skipping frame") == 2 and "skipping frame 1" not in out
    assert [p.read_bytes() for p in paths] == first
    assert [paths[0].stat().st_mtime_ns,
            paths[2].stat().st_mtime_ns] == [mtimes[0], mtimes[2]]


def test_pipelined_drains_in_order_while_the_next_item_dispatches():
    """Each drain runs on the writer thread, in order, and drain i is
    still running when item i+1 is dispatched."""
    log = []
    drain_started = [threading.Event() for _ in range(3)]
    release = [threading.Event() for _ in range(3)]

    def dispatch(i):
        if i:  # the previous drain has begun and is held open
            assert drain_started[i - 1].wait(5)
            assert not release[i - 1].is_set()
            release[i - 1].set()
        log.append(("dispatch", i))
        return i * 10

    def drain(i, result):
        assert threading.current_thread() is not threading.main_thread()
        drain_started[i].set()
        if i < 2:
            assert release[i].wait(5)
        log.append(("drain", i, result))

    pipelined(range(3), dispatch, drain)
    assert [e for e in log if e[0] == "drain"] == [
        ("drain", 0, 0), ("drain", 1, 10), ("drain", 2, 20)]
    assert log.index(("dispatch", 1)) < log.index(("drain", 0, 0))


def test_pipelined_raises_a_drain_error_and_stops():
    dispatched = []

    def drain(i, _):
        if i == 1:
            raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        pipelined(range(5), dispatched.append, drain)
    assert dispatched == [0, 1, 2]


def test_cli_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    args = ["-f", "1", "-s", "128x128", "--Synthetic"]
    monkeypatch.delenv("VVC_MIP_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VVC_MIP_PLATFORM=cpu"):
        tcli.main(args)
    monkeypatch.setenv("VVC_MIP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="VVC_MIP_PLATFORM"):
        tcli.main(args)


@pytest.mark.parametrize("flags", [["--MeshData", "2"], ["--MeshSpace", "2"],
                                   ["--LatencyMode"], ["--NumProcesses", "2"],
                                   ["--Coordinator", "localhost:1234"],
                                   ["--ProcessId", "1"]])
def test_cli_refuses_the_multi_device_flags(flags, on_cpu):
    with pytest.raises(ValueError, match="ROADMAP A.8"):
        tcli.main(["-f", "1", "-s", "128x128", "--Synthetic", *flags])


def test_cli_checks_its_arguments(on_cpu):
    base = ["-f", "1", "-s", "128x128", "--Synthetic"]
    with pytest.raises(ValueError, match="TargetCTU"):
        tcli.main(base + ["--TargetCTU", "1"])
    with pytest.raises(ValueError, match="KernelIdx"):
        tcli.main(base + ["--FilterType", "filterFrame_1d_int_5x5",
                          "--KernelIdx", "3"])
    with pytest.raises(ValueError, match="resolution"):
        tcli.main(["-s", "128by128"])
