"""The port's spans (utils/timing.py): nothing but a flag check while no
profiler records; under a CPU ``torch.profiler`` the engine's, the
latency engine's, the readback ring's and the stage timer's spans,
nested; the card timed only on the batch path; the bounded store; the
per-layer readers of ``portbench/metrics/`` that read the profiled
stretch's spans; and ``tools/idle_by_span.py`` on a hand-written
trace."""

import contextlib
import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, program_spans
from vvc_mip_gpu_tpu_torch.models import cost_engine
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.parallel.latency_engine import LatencyMipCostEngine
from vvc_mip_gpu_tpu_torch.tools import idle_by_span
from vvc_mip_gpu_tpu_torch.utils import timing
from vvc_mip_gpu_tpu_torch.utils.readback import ReadbackRing

W, H = 64, 64


@pytest.fixture(autouse=True)
def _empty_store():
    timing.clear()
    yield
    timing.clear()


@contextlib.contextmanager
def _profiled():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


def _frames(n=1):
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, 1024, (n, H, W), dtype=np.int32))


def test_off_span_does_nothing(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a profiler range entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timing.span("a") is timing.span("b", torch.device("cpu"))
    with timing.span("a"), timing.span("b", torch.device("cpu")):
        pass
    timer = timing.StageTimer()
    with timer.stage("READ SAMPLES"):
        pass
    assert timer.counts["READ SAMPLES"] == 1
    assert timing.spans() == [] and timing.dropped() == 0


def test_engine_spans_under_profiler():
    engine = MipCostEngine(W, H, max_performance=True, device="cpu")
    engine.compute_batch(_frames(2))  # the tables, outside the profile
    with _profiled() as prof:
        engine.compute_batch(_frames(2))
    (search,) = timing.spans("engine.search")
    (launch,) = timing.spans("engine.launch")
    assert search.start_ns <= launch.start_ns <= launch.end_ns \
        <= search.end_ns
    assert timing.device_ms("engine.launch") == []  # no CUDA stream
    names = {e.name for e in prof.events()}
    assert {"vvc_mip.engine.search", "vvc_mip.engine.launch"} <= names


@pytest.mark.parametrize("max_performance", [False, True])
def test_combine_span(max_performance):
    """The full report's minSadHad combine is span ``engine.combine``, once
    a call, after ``engine.search`` has closed, with no card time on the
    CPU; the max-performance regime has no combine and records none."""
    engine = MipCostEngine(256, 136, max_performance=max_performance,
                           device="cpu")
    frames = torch.from_numpy(np.random.default_rng(11).integers(
        0, 1024, (2, 136, 256), dtype=np.int32))
    with _profiled() as prof:
        costs = engine.compute_batch(frames)
    combines = timing.spans("engine.combine")
    names = {e.name for e in prof.events()}
    if max_performance:
        assert combines == [] and "vvc_mip.engine.combine" not in names
        assert costs.sad is None and costs.satd is None
        return
    (search,) = timing.spans("engine.search")
    (combine,) = combines
    assert search.end_ns <= combine.start_ns <= combine.end_ns
    assert timing.device_ms("engine.combine") == []  # no CUDA stream
    assert "vvc_mip.engine.combine" in names
    assert torch.equal(costs.min_sad_had,
                       torch.minimum(2 * costs.sad, costs.satd))


def test_latency_engine_and_readback_spans():
    engine = LatencyMipCostEngine(W, H, [torch.device("cpu")])
    frame = _frames()[0].numpy()
    expected = engine.assemble(engine.dispatch(frame))
    ring = ReadbackRing()
    with _profiled():
        costs = engine.assemble(engine.dispatch(frame), ring.read)
    assert torch.equal(costs.min_sad_had, expected.min_sad_had)
    inside = {"latency.upload": "latency.dispatch",
              "engine.search": "latency.dispatch",
              "engine.launch": "engine.search",
              "latency.gather": "latency.assemble",
              "readback.read": "latency.assemble",
              "readback.wait": "readback.read"}
    records = {}
    for s in timing.spans():
        assert s.name not in records  # one of each
        records[s.name] = s
    assert set(records) == set(inside) | {"latency.dispatch",
                                          "latency.assemble"}
    for name, outer in inside.items():
        assert (records[outer].start_ns <= records[name].start_ns
                <= records[name].end_ns <= records[outer].end_ns)
    assert (records["latency.dispatch"].end_ns
            <= records["latency.assemble"].start_ns)


def test_stage_timer_stage_is_a_span():
    timer = timing.StageTimer()
    with _profiled() as prof:
        with timer.stage("READ SAMPLES"):
            with timing.span("inner"):
                pass
    assert timer.counts["READ SAMPLES"] == 1
    (stage,) = timing.spans("stage.READ SAMPLES")
    (inner,) = timing.spans("inner")
    assert stage.start_ns <= inner.start_ns <= inner.end_ns <= stage.end_ns
    assert "vvc_mip.stage.READ SAMPLES" in {e.name for e in prof.events()}


def test_only_the_batch_path_times_the_card(monkeypatch):
    """``compute_batch`` asks ``engine.launch`` for the card's time; the
    per-frame paths (one frame, the latency engine) do not, and no other
    span asks."""
    calls = []

    def recording_span(name, device=None):
        calls.append((name, device))
        return contextlib.nullcontext()

    monkeypatch.setattr(cost_engine, "span", recording_span)
    engine = MipCostEngine(W, H, max_performance=True, device="cpu")
    engine.compute_batch(_frames(2))
    assert calls == [("engine.search", None),
                     ("engine.launch", torch.device("cpu"))]
    calls.clear()
    engine(_frames()[0])
    latency = LatencyMipCostEngine(W, H, [torch.device("cpu")])
    latency(_frames()[0].numpy())
    assert calls == [("engine.search", None), ("engine.launch", None)] * 2


def test_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 2)
    with _profiled():
        for _ in range(5):
            with timing.span("s"):
                pass
    assert len(timing.spans("s")) == 2 and timing.dropped() == 3
    timing.clear()
    assert timing.spans() == [] and timing.dropped() == 0


def test_threads_lose_no_update(monkeypatch):
    """Spans from more threads than cores, switching often, past the
    store's cap: it keeps exactly its cap and counts every other span as
    dropped."""
    n_threads, n, cap = 16, 500, 5000
    monkeypatch.setattr(timing, "MAX_SPANS", cap)
    interval = sys.getswitchinterval()

    def worker():
        for _ in range(n):
            with timing.span("t"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(timing.spans("t")) == cap
    assert timing.dropped() == n_threads * n - cap


HOST_READERS = {"upload_ms_p50": "latency.upload",
                "launch_ms_p50": "engine.launch",
                "gather_ms_p50": "latency.gather",
                "readback_wait_ms_p50": "readback.wait"}


def _record_warm_up_then_stretch(monkeypatch):
    """Spans of each reader's name in a profiled warm-up step (slow), a
    pause, then a profiled stretch (fast); the stretch's host ms."""
    monkeypatch.setattr(program_spans, "PAUSE_S", 0.05)
    with _profiled():
        for name in HOST_READERS.values():
            with timing.span(name):
                time.sleep(0.01)
    time.sleep(0.1)
    since = time.perf_counter_ns()
    with _profiled():
        for name in HOST_READERS.values():
            for _ in range(3):
                with timing.span(name):
                    pass
    return {name: timing.host_ms(name, since)
            for name in HOST_READERS.values()}


@pytest.mark.parametrize("metric", sorted(HOST_READERS)
                         + ["kernels_ms_per_batch"])
def test_readers(metric, monkeypatch):
    read = harness.reader(metric)
    own, other = (("engine_batch", "cli_latency")
                  if metric == "kernels_ms_per_batch"
                  else ("cli_latency", "engine_batch"))
    assert read(types.SimpleNamespace(entry=own)) is None  # no record
    stretch = _record_warm_up_then_stretch(monkeypatch)
    if metric == "kernels_ms_per_batch":
        since = program_spans.stretch_start_ns()
        monkeypatch.setattr(timing, "device_ms", lambda name, since_ns=0: {
            ("engine.launch", since): [2.0, 4.0]}.get((name, since_ns), []))
        assert read(types.SimpleNamespace(entry=own)) == 3.0
    else:
        value = read(types.SimpleNamespace(entry=own))
        assert len(stretch[HOST_READERS[metric]]) == 3
        assert value == sorted(stretch[HOST_READERS[metric]])[1]
        assert value < 10.0  # not the warm-up's
    assert read(types.SimpleNamespace(entry=other)) is None


@pytest.mark.parametrize("metric", ["combine_ms_per_batch",
                                    "combine_roofline"])
def test_combine_readers(metric, monkeypatch):
    """The combine's readers take the stretch's ``engine.combine`` card
    times, in engine_batch cells only, and nothing where the program
    recorded none (a program without the span)."""
    read = harness.reader(metric)
    cell = harness.load_cell("b1080-full-resident")
    own = types.SimpleNamespace(entry="engine_batch", cell=cell)
    assert read(own) is None  # no record
    _record_warm_up_then_stretch(monkeypatch)
    since = program_spans.stretch_start_ns()
    monkeypatch.setattr(timing, "device_ms", lambda name, since_ns=0: {
        ("engine.combine", since): [1.0, 2.0]}.get((name, since_ns), []))
    want = {"combine_ms_per_batch": 1.5,
            # SAD and SATD read, minSadHad written: 3 x 16 x 135 x 97840
            # int32 at 3.35 TB/s
            "combine_roofline": 100.0 * 2_536_012_800 / 3.35e9 / 1.5}[metric]
    assert read(own) == pytest.approx(want, rel=1e-12)
    other = types.SimpleNamespace(entry="cli_latency", cell=cell)
    assert read(other) is None


def test_readback_overlap_reader(monkeypatch):
    """``readback_overlap_share``: 100 x (1 - the CLI read's mean card ms
    / the stretch's ``readback.part`` card ms per ``readback.read``), in
    cli_step cells only, and nothing where the program recorded no part
    (a program that reads back in one copy)."""
    read = harness.reader("readback_overlap_share")
    own = types.SimpleNamespace(entry="cli_step",
                                device_ms=lambda name: {
                                    "cli.read": [2.0, 4.0]}.get(name, []))
    assert read(own) is None  # no record
    monkeypatch.setattr(program_spans, "PAUSE_S", 0.05)
    with _profiled():
        with timing.span("readback.read"):
            time.sleep(0.01)
    time.sleep(0.1)
    with _profiled():
        for _ in range(2):
            with timing.span("readback.read"):
                pass
    assert read(own) is None  # reads, but no part
    since = program_spans.stretch_start_ns()
    monkeypatch.setattr(timing, "device_ms", lambda name, since_ns=0: {
        ("readback.part", since): [5.0] * 4}.get((name, since_ns), []))
    # 20 ms of copies over 2 reads, 3 ms of it exposed a read
    assert read(own) == pytest.approx(70.0, rel=1e-12)
    assert read(types.SimpleNamespace(entry="engine_batch")) is None


def test_readback_parts_reader(monkeypatch):
    """``readback_parts_per_frame``: the stretch's ``readback.part`` spans
    over its ``readback.read`` spans, in cli_latency cells only, and
    nothing where the program recorded no part (a frame read back in one
    copy) or no read."""
    read = harness.reader("readback_parts_per_frame")
    own = types.SimpleNamespace(entry="cli_latency")
    assert read(own) is None  # no record
    monkeypatch.setattr(program_spans, "PAUSE_S", 0.05)
    with _profiled():  # a warm-up step of another shape
        with timing.span("readback.part"):
            time.sleep(0.01)
        with timing.span("readback.read"):
            pass
    time.sleep(0.1)
    with _profiled():
        for _ in range(2):
            with timing.span("readback.read"):
                pass
    assert read(own) is None  # reads, but no part
    with _profiled():
        for _ in range(6):
            with timing.span("readback.part"):
                pass
    assert read(own) == 3.0
    for entry in ("cli_step", "engine_batch"):
        assert read(types.SimpleNamespace(entry=entry)) is None


def test_stretch_is_after_the_last_pause(monkeypatch):
    """Records from the last pause longer than ``PAUSE_S`` on: a pause is
    measured from the latest end so far, so a span that outlasts those
    after it (the CLI's stage around the others) bridges no pause."""
    monkeypatch.setattr(program_spans, "PAUSE_S", 1.0)
    S = 1_000_000_000
    records = [timing.Span("a", 0, 1 * S, None),
               timing.Span("outer", 3 * S, 10 * S, None),
               timing.Span("b", 4 * S, 5 * S, None),
               timing.Span("c", int(9.5 * S), 10 * S, None),
               timing.Span("d", int(10.5 * S), 11 * S, None)]
    monkeypatch.setattr(timing, "spans", lambda name=None: records)
    assert program_spans.stretch_start_ns() == 3 * S
    monkeypatch.setattr(timing, "spans", lambda name=None: [])
    assert program_spans.stretch_start_ns() is None
    monkeypatch.delattr(timing, "spans")  # a program without the spans
    assert program_spans.stretch_start_ns() is None
    assert program_spans.host_ms("x") is None


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_by_span_on_a_known_trace(tmp_path, capsys):
    events = [
        _x("vvc_mip.latency.dispatch", "user_annotation", 0, 100),
        _x("vvc_mip.latency.upload", "cpu_op", 0, 30),
        _x("aten::copy_", "cpu_op", 0, 20),
        _x("mip_cost_sid1_kernel", "kernel", 40, 20),
        _x("Memcpy DtoH", "gpu_memcpy", 50, 30),
        _x("vvc_mip.latency.assemble", "cpu_op", 120, 80),
        # the device's copy of a host range is not device work
        _x("vvc_mip.latency.assemble", "gpu_user_annotation", 125, 70),
        _x("portbench.other", "user_annotation", 150, 70),
        _x("cat", "kernel", 150, 10),
        _x("Memset", "gpu_memset", 200, 5),
        _x("last", "kernel", 210, 10),
        {"ph": "i", "name": "marker", "ts": 500},
    ]
    report = idle_by_span.idle_gaps(idle_by_span.chrome_intervals(events))
    assert report["window_s"] == pytest.approx(220e-6)
    assert report["busy_s"] == pytest.approx(65e-6)
    assert report["idle_s"] == pytest.approx(155e-6)
    gaps = dict(report["idle_gaps"])
    assert gaps == pytest.approx({"latency.upload": 40e-6,
                                  "latency.dispatch": 70e-6,
                                  "latency.assemble": 40e-6,
                                  "outside": 5e-6})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    idle_by_span.main([str(path)])
    assert json.loads(capsys.readouterr().out) == report


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_device_spans_on_the_card():
    engine = MipCostEngine(1920, 1080, max_performance=True)
    frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 1024, (4, 1080, 1920), dtype=np.int32)).cuda()
    engine.compute_batch(frames)  # builds and loads the kernels
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        start.record()
        engine.compute_batch(frames)
        end.record()
        torch.cuda.synchronize()
    search = start.elapsed_time(end)  # the casts as well
    (launch,) = timing.device_ms("engine.launch")
    assert 0 < launch <= search
