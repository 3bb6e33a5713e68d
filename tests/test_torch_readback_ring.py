"""The CLI's readback ring (utils/readback.py): two reused host buffers
per output field, so that a chunk's readback never overwrites the arrays
the writer thread is still exporting.  The CLI's single-engine, latency
and mesh paths with one frame a chunk and drains slowed until the next
chunk's readback is done write the files of a one-chunk run byte for
byte; the latency engine's own results are the caller's.  The part plan
of the CLI's step, a read in parts filling its rows and keeping the
two-slot contract, the CPU step in one pass, and (on the card) the
parted step bit-exact against the one-pass step.  The latency engine's
SizeId parts: their blocks of columns, a read in blocks of columns, the
CLI's latency step with the ring against the engine's own call, the
blocks' copies under a profiler, and (on the card) the step in SizeId
parts bit-exact against ``compute_batch``."""

import contextlib
import filecmp
import io
import itertools
import threading

import numpy as np
import pytest
import torch

from vvc_mip_gpu_tpu_torch import cli as tcli
from vvc_mip_gpu_tpu_torch.constants import num_ctus
from vvc_mip_gpu_tpu_torch.io import export as texport
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models import cost_engine as tce
from vvc_mip_gpu_tpu_torch.models.cost_engine import PER_CTU, MipCostEngine
from vvc_mip_gpu_tpu_torch.ops.filters import filter_frames
from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans
from vvc_mip_gpu_tpu_torch.parallel import latency_engine as tlat
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine
from vvc_mip_gpu_tpu_torch.utils import readback, timing
from vvc_mip_gpu_tpu_torch.utils.config import EngineConfig
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


# the JVET sizes, 416x240 up to 3840x2160
SIZES = [(416, 240), (832, 480), (1280, 720), (1920, 1080), (3840, 2160)]
FILTER = ("filterFrame_2d_int_quarterCtu", 2)


@pytest.mark.parametrize("width, height", SIZES)
def test_part_plan(width, height):
    """Every chunk of 1 to 16 frames: consecutive parts of whole frames
    that cover it once, in order, each of at least ``MIN_PART_CTUS`` CTUs
    unless the chunk is one part, as many parts as that allows, even to a
    frame; one part on the CPU.  At 4K a batch of 16 is searched in parts
    of one or two frames."""
    ctus = num_ctus(width, height)[2]
    least = readback.MIN_PART_CTUS
    for n in range(1, 17):
        assert readback.part_plan("cpu", n, ctus) == [(0, n)]
        parts = readback.part_plan("cuda", n, ctus)
        assert [b0 for b0, _ in parts] == [0] + [b1 for _, b1 in parts[:-1]]
        assert parts[-1][1] == n
        sizes = [b1 - b0 for b0, b1 in parts]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes)
        if len(parts) > 1:
            assert min(sizes) * ctus >= least
        # one part more would leave a part below the minimum
        assert n // (len(parts) + 1) * ctus < least
        if (width, height) == (3840, 2160) and n == 16:
            assert max(sizes) <= 2


def test_parted_read_fills_rows_and_keeps_two_slots():
    """A read in parts puts each part in its rows of the next slot and
    shares the slots with whole reads: its arrays stay until the slot
    comes round again."""
    ring = ReadbackRing()
    a = torch.arange(5 * 3, dtype=torch.int32).view(5, 3)
    pending = ring.parted(5)
    pending.copy(0, a[:2], None, a[:2] + 100)
    pending.copy(2, a[2:], None, a[2:] + 100)
    first, none, other = pending.read()
    assert none is None
    np.testing.assert_array_equal(first, a.numpy())
    np.testing.assert_array_equal(other, a.numpy() + 100)
    second, = ring.read(a + 10)
    np.testing.assert_array_equal(first, a.numpy())  # the other slot
    pending = ring.parted(5)
    for b0, b1 in [(0, 1), (1, 3), (3, 5)]:
        pending.copy(b0, a[b0:b1] + 20, None, a[b0:b1] + 120)
    third, _, _ = pending.read()
    np.testing.assert_array_equal(first, third)  # slot 0 again
    np.testing.assert_array_equal(third, a.numpy() + 20)
    np.testing.assert_array_equal(second, (a + 10).numpy())


def _step(max_performance, filtered, n_frames):
    """The CLI's single-engine step on the CPU at 128x128: (enqueue, read,
    frames, refs)."""
    ft, ki = FILTER if filtered else (None, 0)
    cfg = EngineConfig(width=128, height=128, n_frames=n_frames,
                       filter_type=ft, kernel_idx=ki,
                       max_performance=max_performance,
                       batch_frames=n_frames)
    _, enqueue, read = tcli._searcher(cfg, torch.device("cpu"), n_frames)
    frames = torch.from_numpy(synthetic_frames(
        n_frames, 128, 128, seed=5).astype(np.int32))
    refs = filter_frames(frames, *FILTER) if filtered else None
    return enqueue, read, frames, refs


def test_cpu_step_is_one_pass(monkeypatch):
    """On the CPU each chunk is one ``compute_batch`` and one
    ``ReadbackRing.read``, even where the plan would part it on CUDA:
    the path the benchmark's planted faults go through."""
    monkeypatch.setattr(readback, "MIN_PART_CTUS", 1)
    calls = {"compute_batch": 0, "read": 0}

    def counted(cls, name, key):
        original = getattr(cls, name)

        def wrapper(*args, **kwargs):
            calls[key] += 1
            return original(*args, **kwargs)

        monkeypatch.setattr(cls, name, wrapper)

    counted(MipCostEngine, "compute_batch", "compute_batch")
    counted(ReadbackRing, "read", "read")
    enqueue, read, frames, _ = _step(True, False, 3)
    for k, pocs in enumerate(([0, 1], [2]), start=1):
        msh, sad, satd = read(enqueue(frames, None, pocs), len(pocs))
        assert msh.shape[0] == len(pocs) and sad is None and satd is None
        assert calls == {"compute_batch": k, "read": k}


@pytest.mark.parametrize("max_performance, filtered",
                         [(True, False), (False, True)])
def test_parted_step_equals_one_pass_on_the_cpu(max_performance, filtered,
                                                monkeypatch):
    """The CLI's step with the chunk forced into uneven parts returns the
    one-pass step's arrays, one ``readback.part`` span a part."""
    enqueue, read, frames, refs = _step(max_performance, filtered, 3)
    want = [a.copy() for a in read(enqueue(frames, refs, [0, 1, 2]), 3)
            if a is not None]
    monkeypatch.setattr(tcli, "part_plan", lambda *_: [(0, 1), (1, 3)])
    timing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [a for a in read(enqueue(frames, refs, [0, 1, 2]), 3)
               if a is not None]
    assert len(timing.spans("readback.part")) == 2
    assert len(timing.spans("readback.read")) == 1
    timing.clear()
    assert len(got) == len(want) == (1 if max_performance else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _assert_equal_on(device, host_arrays, tensors):
    for a, t in zip(host_arrays, tensors):
        assert (a is None) == (t is None)
        if a is not None:
            assert torch.equal(torch.from_numpy(a).to(device), t)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
@pytest.mark.parametrize("width, height", [(1920, 1080), (3840, 2160)])
def test_parted_step_is_bit_exact_on_the_card(width, height):
    """The CLI's step on the card (in parts where the plan parts the
    chunk, unevenly at 11 frames), for chunks of 1, 3, 11 and 16 frames,
    max-performance and full
    report, original and filtered references, returns the host arrays of
    the one-pass step's costs (``compute_batch`` on the whole chunk),
    compared on the card; a second read leaves the first's arrays, a
    third reuses their slot."""
    device = torch.device("cuda")
    pool = torch.from_numpy(np.random.default_rng(width).integers(
        0, 1024, (18, height, width), dtype=np.int32)).to(device)
    filtered = filter_frames(pool, *FILTER)
    for chunk, max_performance, refs in itertools.product(
            (1, 3, 11, 16), (True, False), (None, filtered)):
        ft, ki = FILTER if refs is not None else (None, 0)
        cfg = EngineConfig(width=width, height=height, n_frames=18,
                           filter_type=ft, kernel_idx=ki,
                           max_performance=max_performance,
                           batch_frames=chunk)
        _, enqueue, read = tcli._searcher(cfg, device, 18)
        engine = MipCostEngine(width, height,
                               max_performance=max_performance,
                               device=device)

        def one_pass(i):
            c = engine.compute_batch(
                pool[i:i + chunk],
                None if refs is None else refs[i:i + chunk])
            return c.min_sad_had, c.sad, c.satd

        pocs = [list(range(i, i + chunk)) for i in range(3)]
        first = read(enqueue(pool, refs, pocs[0]), chunk)
        want = one_pass(0)
        _assert_equal_on(device, first, want)
        second = read(enqueue(pool, refs, pocs[1]), chunk)
        _assert_equal_on(device, second, one_pass(1))
        _assert_equal_on(device, first, want)
        third = read(enqueue(pool, refs, pocs[2]), chunk)
        _assert_equal_on(device, third, one_pass(2))
        assert all(a is None or np.shares_memory(a, b)
                   for a, b in zip(first, third))
        del first, second, third, want


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
@pytest.mark.parametrize("width, height, chunk",
                         [(1920, 1080, 16), (3840, 2160, 5)])
def test_part_spans_time_the_copies_on_the_card(width, height, chunk):
    """Under a profiler one parted step records one ``readback.part`` per
    part, each with a time on the card, inside one ``readback.read``."""
    device = torch.device("cuda")
    cfg = EngineConfig(width=width, height=height, n_frames=chunk,
                       max_performance=True, batch_frames=chunk)
    _, enqueue, read = tcli._searcher(cfg, device, chunk)
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1024, (chunk, height, width), dtype=np.int32)).to(device)
    read(enqueue(frames, None, list(range(chunk))), chunk)  # warm
    parts = readback.part_plan("cuda", chunk, num_ctus(width, height)[2])
    assert len(parts) > 1
    timing.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        read(enqueue(frames, None, list(range(chunk))), chunk)
    copies = timing.device_ms("readback.part")
    assert len(copies) == len(parts) and all(ms > 0 for ms in copies)
    assert len(timing.spans("readback.read")) == 1
    timing.clear()


@pytest.mark.parametrize("width, height", SIZES)
def test_size_parts_cover_every_column_once(width, height):
    """The latency engine's SizeId parts: SizeId 0, 1 and 2 in that order,
    each with every class of its SizeId and one block of columns holding
    exactly the columns its classes write; the three blocks tile the
    97840 columns."""
    plans = class_plans(width, height)
    parts = tlat.size_parts(width, height)
    assert [{plans[i].shape.size_id for i in classes}
            for classes, _ in parts] == [{0}, {1}, {2}]
    assert sorted(i for classes, _ in parts for i in classes) == list(
        range(len(plans)))
    seen = np.zeros(PER_CTU, int)
    for classes, cols in parts:
        written = np.zeros(PER_CTU, bool)
        for c in tce._columns(width, height, classes):
            written[c] = True
        assert np.flatnonzero(written).tolist() == list(
            range(cols.start, cols.stop))
        seen[cols] += 1
    assert (seen == 1).all()


def test_read_in_blocks_of_columns_keeps_the_rest_and_two_slots():
    """Blocks of columns (views of wider tensors) land in their columns
    of the next slot and nothing else there changes; the read's arrays
    stay until the slot comes round again."""
    ring = ReadbackRing()
    sentinel = torch.full((1, 3, 10), -1, dtype=torch.int32)
    ring.read(sentinel, sentinel)  # slot 0, as a whole read left it
    ring.read(sentinel + 1)  # slot 1
    a = torch.arange(3 * 10, dtype=torch.int32).view(1, 3, 10)
    pending = ring.parted(10)
    pending.copy_columns(6, a[..., 6:10], None)
    pending.copy_columns(0, a[..., 0:2], None)
    first, none = pending.read()
    assert none is None and first.shape == (1, 3, 10)
    want = np.full((1, 3, 10), -1, np.int32)
    want[..., :2] = a.numpy()[..., :2]
    want[..., 6:] = a.numpy()[..., 6:]
    np.testing.assert_array_equal(first, want)
    second, = ring.read(a + 10)
    np.testing.assert_array_equal(first, want)  # the other slot
    pending = ring.parted(10)
    pending.copy_columns(0, (a + 20)[..., :10].contiguous(), None)
    third, _ = pending.read()
    assert np.shares_memory(first, third)  # slot 0 again
    np.testing.assert_array_equal(third, a.numpy() + 20)
    np.testing.assert_array_equal(second, a.numpy() + 10)


def _latency_inputs(filtered):
    frames = torch.from_numpy(synthetic_frames(
        2, 128, 128, seed=8).astype(np.int32))
    refs = filter_frames(frames, *FILTER) if filtered else None
    return frames, refs


@pytest.mark.parametrize("max_performance, filtered",
                         [(True, False), (False, True)])
def test_latency_step_with_the_ring_equals_the_engines_call(
        max_performance, filtered, monkeypatch):
    """The CLI's --LatencyMode step on the CPU (one frame a chunk, the
    ring handed to ``dispatch``) returns [1, nCTU, 97840] arrays equal to
    ``LatencyMipCostEngine.__call__``'s; on the CPU the engine reads the
    frame in one copy after its search."""
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    frames, refs = _latency_inputs(filtered)
    ft, ki = FILTER if filtered else (None, 0)
    cfg = EngineConfig(width=128, height=128, n_frames=2, filter_type=ft,
                       kernel_idx=ki, max_performance=max_performance,
                       latency_mode=True)
    _, enqueue, read = tcli._searcher(cfg, torch.device("cpu"), 2)
    engine = LatencyMipCostEngine(128, 128, [torch.device("cpu")],
                                  max_performance=max_performance)
    assert engine._size_parts is None
    for k in range(2):
        outs = enqueue(frames, refs, [k])
        assert isinstance(outs, list)
        got = read(outs, 1)
        want = engine(frames[k], None if refs is None else refs[k])
        for a, t in zip(got, (want.min_sad_had, want.sad, want.satd)):
            assert (a is None) == (t is None)
            if a is not None:
                assert a.shape == (1, *t.shape)
                np.testing.assert_array_equal(a[0], t.numpy())


@pytest.mark.parametrize("max_performance, filtered",
                         [(True, False), (False, True)])
def test_size_id_parts_copy_each_block_once(max_performance, filtered,
                                            monkeypatch):
    """The one-part engine made to search in SizeId parts (as on a card)
    on the CPU, under a profiler: the classes run SizeId 0, 1, 2, one
    ``readback.part`` a SizeId inside ``latency.dispatch``, one
    ``readback.read`` and one ``latency.gather`` inside
    ``latency.assemble``, the full report's minSadHad formed a block at a
    time by ``_combine``, and the costs equal the engine's own call."""
    frames, refs = _latency_inputs(filtered)
    engine = LatencyMipCostEngine(128, 128, [torch.device("cpu")],
                                  max_performance=max_performance)
    want = engine(frames[0], None if refs is None else refs[0])
    engine._size_parts = tlat.size_parts(128, 128)
    searched, combined = [], []
    run_classes, combine = tce._run_classes, tce._combine

    def recording(*args, **kwargs):
        searched.append(args[7])
        return run_classes(*args, **kwargs)

    def counting(*args, **kwargs):
        combined.append(args[0].shape[-1])
        return combine(*args, **kwargs)

    monkeypatch.setattr(tce, "_run_classes", recording)
    monkeypatch.setattr(tce, "_combine", counting)
    ring = ReadbackRing()
    timing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = engine.dispatch(frames[0], None if refs is None else refs[0],
                               ring)
        assert isinstance(outs, tlat.PartedFrame)
        got = engine.assemble(outs, ring.read)
    plans = class_plans(128, 128)
    assert [{plans[i].shape.size_id for i in classes}
            for classes in searched] == [{0}, {1}, {2}]
    widths = [c.stop - c.start for _, c in engine._size_parts]
    assert combined == ([] if max_performance else widths)
    dispatch, = timing.spans("latency.dispatch")
    assemble, = timing.spans("latency.assemble")
    parts = timing.spans("readback.part")
    assert len(parts) == 3
    for inner, outer in ([(p, dispatch) for p in parts]
                         + [(s, assemble) for s in timing.spans()
                            if s.name in ("readback.read",
                                          "latency.gather")]):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert len(timing.spans("readback.read")) == 1
    assert len(timing.spans("latency.gather")) == 1
    timing.clear()
    for field in ("sad", "satd", "min_sad_had"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None)
        if w is not None:
            assert torch.equal(g, w), field


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("max_performance", [True, False])
def test_latency_step_in_size_id_parts_is_bit_exact_on_the_card(
        n_parts, max_performance):
    """The CLI's --LatencyMode step on the card at 1920x1080 (one part:
    SizeId parts, each block copied while the next searches; two parts on
    two streams: one copy after the gather), original and filtered
    references, returns the host arrays of ``compute_batch``'s costs; a
    second read leaves the first's arrays, a third reuses their slot."""
    device = torch.device("cuda")
    width, height = 1920, 1080
    pool = torch.from_numpy(np.random.default_rng(n_parts).integers(
        0, 1024, (3, height, width), dtype=np.int32)).to(device)
    filtered = filter_frames(pool, *FILTER)
    engine = LatencyMipCostEngine(width, height, [device] * n_parts,
                                  max_performance=max_performance)
    batch = MipCostEngine(width, height, max_performance=max_performance,
                          device=device)
    ring = ReadbackRing()
    for refs in (None, filtered):
        def step(k):
            outs = engine.dispatch(pool[k],
                                   None if refs is None else refs[k], ring)
            assert isinstance(outs, tlat.PartedFrame) == (n_parts == 1)
            c = engine.assemble(outs, ring.read)
            return [None if t is None else t.numpy()
                    for t in (c.min_sad_had, c.sad, c.satd)]

        def want(k):
            c = batch.compute_batch(pool[k:k + 1],
                                    None if refs is None else refs[k:k + 1])
            return [None if t is None else t[0]
                    for t in (c.min_sad_had, c.sad, c.satd)]

        first = step(0)
        _assert_equal_on(device, first, want(0))
        second = step(1)
        _assert_equal_on(device, second, want(1))
        _assert_equal_on(device, first, want(0))
        third = step(2)
        _assert_equal_on(device, third, want(2))
        assert all(a is None or np.shares_memory(a, b)
                   for a, b in zip(first, third))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_size_id_copies_are_timed_on_the_card():
    """Under a profiler the CLI's --LatencyMode step on one card records
    three ``readback.part`` spans a frame, each with a time on the card,
    and one ``readback.read``."""
    device = torch.device("cuda")
    cfg = EngineConfig(width=1920, height=1080, n_frames=1,
                       max_performance=True, latency_mode=True)
    _, enqueue, read = tcli._searcher(cfg, device, 1)
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1024, (1, 1080, 1920), dtype=np.int16)).to(device)
    read(enqueue(frames, None, [0]), 1)  # warm
    timing.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        read(enqueue(frames, None, [0]), 1)
    copies = timing.device_ms("readback.part")
    assert len(copies) == 3 and all(ms > 0 for ms in copies)
    assert len(timing.spans("readback.read")) == 1
    timing.clear()
