"""The CLI's readback ring (utils/readback.py): two reused host buffers
per output field, so that a chunk's readback never overwrites the arrays
the writer thread is still exporting.  The CLI's single-engine, latency
and mesh paths with one frame a chunk and drains slowed until the next
chunk's readback is done write the files of a one-chunk run byte for
byte; the latency engine's own results are the caller's."""

import contextlib
import filecmp
import io
import threading

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu_torch import cli as tcli
from vvc_mip_gpu_tpu_torch.io import export as texport
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine
from vvc_mip_gpu_tpu_torch.utils import readback
from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

CLI_ARGS = ["-f", "4", "-s", "128x128", "--Synthetic", "--FullDistortion",
            "--TargetCTU", "0"]
FILES = [f"mip_decisions_poc{f}.csv" for f in range(4)] + ["target_ctu0.csv"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_chunk(tmp_path_factory):
    """The output prefix of a run that searches all 4 frames in one
    chunk: nothing is read back while a drain runs."""
    prefix = str(tmp_path_factory.mktemp("one_chunk") / "o_")
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        mp.setenv("VVC_MIP_PLATFORM", "cpu")
        assert tcli.main(CLI_ARGS + ["--BatchFrames", "4", "-l", prefix]) == 0
    return prefix


def test_ring_reuses_two_slots():
    ring = ReadbackRing()
    a = torch.arange(6, dtype=torch.int32).view(2, 3)
    first, none = ring.read(a, None)
    second, = ring.read(a + 10)
    assert none is None
    np.testing.assert_array_equal(first, a.numpy())  # the other slot
    third, = ring.read(a + 20)
    np.testing.assert_array_equal(first, third)  # slot 0 again
    np.testing.assert_array_equal(second, (a + 10).numpy())
    bigger, = ring.read(torch.arange(12, dtype=torch.int32))
    np.testing.assert_array_equal(bigger, np.arange(12))
    assert readback.SLOTS == 2


@pytest.mark.parametrize("flags, chunk", [([], 1), (["--LatencyMode"], 1),
                                          (["--MeshData", "2"], 2)])
def test_overlapping_drains_write_the_one_chunk_files(
        flags, chunk, one_chunk, tmp_path, monkeypatch, capsys):
    """--BatchFrames 1: the export of each chunk waits until the next
    chunk has been searched and read back (so dispatch i+1 overlaps drain
    i for certain); the files equal the one-chunk run's.  A ring of one
    buffer fails here: its next readback overwrites the arrays the drain
    is about to write."""
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    n_chunks = 4 // chunk
    done = threading.Condition()
    reads = [0]
    ring_read = ReadbackRing.read

    def counted_read(self, *tensors):
        out = ring_read(self, *tensors)
        with done:
            reads[0] += 1
            done.notify_all()
        return out

    export = texport.export_decisions_csv

    def slow_export(path, msh, width, sad=None, satd=None, poc=None):
        want = min(poc // chunk + 2, n_chunks)
        with done:
            assert done.wait_for(lambda: reads[0] >= want, timeout=60), (
                f"chunk {poc // chunk + 1} was not read back during the "
                f"drain of chunk {poc // chunk}")
        export(path, msh, width, sad=sad, satd=satd, poc=poc)

    monkeypatch.setattr(ReadbackRing, "read", counted_read)
    monkeypatch.setattr(texport, "export_decisions_csv", slow_export)
    prefix = str(tmp_path / "p_")
    assert tcli.main(CLI_ARGS + flags + ["--BatchFrames", "1",
                                         "-l", prefix]) == 0
    assert reads[0] == n_chunks
    assert capsys.readouterr().out.count("=== DISTORTION, CTU 0") == 4
    for name in FILES:
        assert filecmp.cmp(prefix + name, one_chunk + name, shallow=False), (
            name)


def test_latency_engine_results_stay_the_callers():
    """A second call of the latency engine leaves the first call's host
    tensors as they were (the engine reads back into new memory, never
    into a ring)."""
    frames = synthetic_frames(2, 128, 128, seed=3).astype(np.int32)
    engine = LatencyMipCostEngine(128, 128, [torch.device("cpu")] * 2,
                                  max_performance=False)
    first = engine(frames[0])
    kept = [t.clone() for t in (first.sad, first.satd, first.min_sad_had)]
    second = engine(frames[1])
    for got, want in zip((first.sad, first.satd, first.min_sad_had), kept):
        assert torch.equal(got, want)
    assert not torch.equal(first.min_sad_had, second.min_sad_had)
