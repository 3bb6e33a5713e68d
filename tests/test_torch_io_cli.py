"""The port's I/O and CLI (vvc_mip_gpu_tpu_torch.io, .cli) against the JAX
package's: the frames CSV and every decisions-CSV variant byte for byte,
the best-mode decision, and one CLI run of each package on the same
synthetic frames (filtered regime, full report, target CTU) writing
byte-identical files.  Then the port's CLI alone: --OnlyFilter, --Resume,
a ragged tail chunk, the device rules (CUDA unless VVC_MIP_PLATFORM=cpu)
and the multi-device paths: a mesh, the latency mode and two processes
write the single-device run's files byte for byte."""

import contextlib
import filecmp
import io
import os
import threading
from pathlib import Path

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
from vvc_mip_gpu_tpu_torch.parallel import distributed as tdistributed
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


# the port's writers: the C writer (the default) and its numpy oracle
WRITERS = {
    "c": (texport.export_decisions_csv, texport.export_target_ctu_csv),
    "numpy": (texport.export_decisions_csv_plain,
              texport.export_target_ctu_csv_plain),
}


@pytest.fixture(scope="module")
def jax_csv(tmp_path_factory):
    """The JAX package's file for a case, written once for both of the
    port's writers: ``jax_csv(key, write, *args, **kwargs)``."""
    root = tmp_path_factory.mktemp("jax_csv")
    done = {}

    def get(key, write, *args, **kwargs):
        if key not in done:
            done[key] = root / f"{len(done)}.csv"
            write(done[key], *args, **kwargs)
        return done[key]

    return get


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("variant", ["msh", "full", "poc", "satd_only",
                                     "negative"])
def test_decisions_csv_bytes(tmp_path, variant, writer, jax_csv):
    msh, sad, satd = _costs(3, seed=len(variant))
    kwargs = {"msh": {}, "full": {"sad": sad, "satd": satd},
              "poc": {"sad": sad, "satd": satd, "poc": 12},
              "satd_only": {"satd": satd, "poc": 0},
              "negative": {"sad": -sad}}[variant]
    if variant == "negative":
        msh = msh - 500_000
    WRITERS[writer][0](tmp_path / "t.csv", msh, 384, **kwargs)
    _same(tmp_path / "t.csv", jax_csv(variant, jexport.export_decisions_csv,
                                      msh, 384, **kwargs))


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_target_ctu_csv_bytes_and_best_modes(tmp_path, writer, jax_csv):
    msh, sad, satd = _costs(2, seed=7)
    for i, kwargs in enumerate(({}, {"sad_per_frame": [sad[0], None],
                                     "satd_per_frame": [satd[0], satd[1]],
                                     "pocs": [4, 9]})):
        WRITERS[writer][1](tmp_path / "t.csv", [msh[0], msh[1]], 256, 1,
                           **kwargs)
        _same(tmp_path / "t.csv", jax_csv(
            f"target{i}", jexport.export_target_ctu_csv, [msh[0], msh[1]],
            256, 1, **kwargs))
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


CLI_FILES = ("mip_decisions_poc0.csv", "mip_decisions_poc1.csv",
             "target_ctu0.csv")


@pytest.fixture(scope="module")
def jax_cli_run(tmp_path_factory):
    """One run of the JAX package's CLI on CLI_ARGS, on the CPU: (output
    prefix, stdout).  Its files are the reference of every port CLI run
    with these flags below."""
    prefix = tmp_path_factory.mktemp("jax_cli") / "j_"
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("VVC_MIP_PLATFORM", "cpu")
        assert jcli.main(CLI_ARGS + ["-l", str(prefix)]) == 0
    return str(prefix), out.getvalue()


def test_cli_matches_the_jax_cli(jax_cli_run, tmp_path, on_cpu, capsys):
    jax_prefix, jax_out = jax_cli_run
    assert tcli.main(CLI_ARGS + ["-l", str(tmp_path / "t_")]) == 0
    out = capsys.readouterr().out
    for name in CLI_FILES:
        _same(tmp_path / f"t_{name}", jax_prefix + name)
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


@pytest.mark.parametrize("flags", [
    ["--MeshData", "2", "--MeshSpace", "2"], ["--LatencyMode"],
    ["--NumProcesses", "2", "--Coordinator", "localhost:1"]])
def test_cli_multi_device_paths_need_a_card(flags, monkeypatch):
    """Without a CUDA device and without VVC_MIP_PLATFORM=cpu the mesh,
    latency and multi-process paths raise (before joining any process
    group) instead of running on the CPU."""
    monkeypatch.delenv("VVC_MIP_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VVC_MIP_PLATFORM=cpu"):
        tcli.main(["-f", "1", "-s", "128x128", "--Synthetic", *flags])


@pytest.mark.parametrize("flags", [["--MeshData", "2"], ["--MeshSpace", "2"],
                                   ["--NumProcesses", "2"]])
def test_cli_latency_mode_rule(flags, on_cpu):
    """The JAX package's rule: --LatencyMode takes every local device by
    itself and combines with no mesh and no second process."""
    with pytest.raises(ValueError, match="--LatencyMode uses all local "
                                         "devices by itself"):
        tcli.main(["-f", "1", "-s", "128x128", "--Synthetic", "--LatencyMode",
                   *flags])


@pytest.mark.parametrize("flags", [["--MeshData", "2"], ["--MeshSpace", "2"],
                                   ["--LatencyMode"]])
def test_cli_multi_device_runs_match_single_device(flags, jax_cli_run,
                                                   tmp_path, on_cpu, capsys):
    """A (2, 1) or (1, 2) mesh of the CPU (the latter pads the height to
    256, a band of padding rows the CLI drops) and the latency mode write
    the single-device run's files (which equal the JAX CLI's) byte for
    byte."""
    assert tcli.main(CLI_ARGS + flags + ["-l", str(tmp_path / "m_")]) == 0
    out = capsys.readouterr().out
    for name in CLI_FILES:
        _same(tmp_path / f"m_{name}", jax_cli_run[0] + name)
    assert out.count("=== DISTORTION, CTU 0") == 2
    for stage in ("ENQUEUE KERNELS", "READ DISTORTION", "WRITE DECISIONS"):
        assert stage in out


def test_cli_mesh_resume_pads_the_chunk_to_the_data_axis(jax_cli_run,
                                                         tmp_path, on_cpu,
                                                         capsys):
    """--Resume on a (2, 1) mesh with frame 0's log present: frame 1 alone
    is searched, padded to the data axis by repeating it, and its log
    equals the single-device run's."""
    prefix = str(tmp_path / "r_")
    Path(prefix + "mip_decisions_poc0.csv").write_bytes(
        Path(jax_cli_run[0] + "mip_decisions_poc0.csv").read_bytes())
    assert tcli.main(CLI_ARGS + ["--MeshData", "2", "--Resume",
                                 "-l", prefix]) == 0
    out = capsys.readouterr().out
    assert "skipping frame 0" in out and out.count("=== DISTORTION") == 1
    _same(prefix + "mip_decisions_poc1.csv",
          jax_cli_run[0] + "mip_decisions_poc1.csv")


def test_cli_two_processes_match_single_process(jax_cli_run, tmp_path):
    """Two CLI processes (gloo on localhost) take a frame each: the union
    of their decisions CSVs and process 0's target-CTU CSV equal the
    single-process run's.  The children run with ``jax`` and the JAX
    package made unimportable, so they use neither."""
    blocker = tmp_path / "blocker"
    for name in ("jax", "vvc_mip_gpu_tpu"):
        (blocker / name).mkdir(parents=True)
        (blocker / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    env = {"VVC_MIP_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(blocker), os.environ.get("PYTHONPATH", "")])}
    outs = tdistributed.launch_cli(
        CLI_ARGS + ["-l", str(tmp_path / "p_")], 2, timeout=120, env=env)
    for i, out in enumerate(outs):
        assert f"[process {i}] exported 1 frames" in out
    assert "target_ctu0.csv" in outs[0] and "target_ctu0.csv" not in outs[1]
    for name in CLI_FILES:
        _same(tmp_path / f"p_{name}", jax_cli_run[0] + name)


def test_cli_checks_its_arguments(on_cpu):
    base = ["-f", "1", "-s", "128x128", "--Synthetic"]
    with pytest.raises(ValueError, match="TargetCTU"):
        tcli.main(base + ["--TargetCTU", "1"])
    with pytest.raises(ValueError, match="KernelIdx"):
        tcli.main(base + ["--FilterType", "filterFrame_1d_int_5x5",
                          "--KernelIdx", "3"])
    with pytest.raises(ValueError, match="resolution"):
        tcli.main(["-s", "128by128"])
