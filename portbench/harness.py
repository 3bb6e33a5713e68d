"""One run of one cell: resolve it from BENCHMARK.json, set up, measure,
judge, and make the result line.

Everything particular to a cell is found by name: its configuration in
the file BENCHMARK.json gives it, its traffic mix in
``portbench/traffic/<traffic>.json`` (parameters, among them the
``entry`` that names the loop), the loop in
``portbench/loops/<entry>.py`` (a ``Loop``, see ``loop.py``), and each
per-layer metric in ``portbench/metrics/<metric>.py`` (a ``read(trace)``
that returns the number, or None where it finds nothing to read).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from portbench import judge
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    root: Path


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], root)


def _load(folder: str, name: str, root: Path):
    """The module ``portbench/<folder>/<name>.py``."""
    path = root / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    return _load("metrics", name, root).read


def loop_class(entry: str, root: Path = ROOT):
    """The ``Loop`` class of ``portbench/loops/<entry>.py``."""
    return _load("loops", entry, root).Loop


def end_to_end_value(name: str, cell: Cell, setup_s: float, frames: int,
                     seconds: float, latencies: list[float]) -> float:
    """An end-to-end metric from the window: ``setup_s``, the traffic's
    ``rate_metric`` (frames over the window's seconds), or
    ``latency_p<q>_ms`` (the q-th percentile of every frame's latency)."""
    if name == "setup_s":
        return setup_s
    if name == cell.traffic.get("rate_metric"):
        return frames / seconds
    m = re.fullmatch(r"latency_p(\d+)_ms", name)
    if m and latencies:
        return float(np.percentile(latencies, int(m.group(1)))) * 1e3
    raise ValueError(f"{cell.name}: the window measures no {name!r}")


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run(cell: Cell, seed: int, seconds: float, traced: bool, devices,
        t_start: float) -> dict:
    """Set up, measure for ``seconds``, judge; the result line's object.
    ``devices``: the cell's cards (or the CPU); ``t_start``: the host
    clock when the process began its set-up."""
    devices = [torch.device(d) for d in devices]
    device = devices[0]
    # loading the loop imports the program's modules that it drives
    loop_type = loop_class(cell.traffic["entry"], cell.root)
    imported = time.perf_counter()
    for d in devices:
        torch.empty(0, device=d)  # the CUDA contexts
    trace = Trace(cell, traced, device)
    loop = loop_type(cell.config, cell.traffic, seed, devices, trace)
    loop.phases = {"imports": imported - t_start,
                   "context": time.perf_counter() - imported}
    loop.setup()
    setup_s = time.perf_counter() - t_start
    frames, window_s = loop.window(seconds)
    on_card = device.type == "cuda"
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices
               ) if on_card else 0

    metrics = {}
    if traced:
        trace.read_profile()
        for m in cell.per_layer:
            value = reader(m["name"], cell.root)(trace)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = _metric(end_to_end_value(
                m["name"], cell, setup_s, frames, window_s, loop.latencies),
                m["unit"])

    loop.release()
    if on_card:
        torch.cuda.empty_cache()
    fields = loop.fields
    picks = judge.select(loop.kept, loop.width, loop.height,
                         cell.traffic["judge_ctus_per_frame"], seed)
    program = judge.program_rows(loop.kept, picks, fields, device)
    reference, valid = judge.reference_rows(loop.pool, picks, loop.filter,
                                            fields, device)
    checks = judge.compare(program, reference, valid, picks)

    result = {
        "correct": checks["mismatched_costs"] == 0
        and checks["judged_costs"] > 0,
        "attempted": frames,
        "failed": checks["failed_frames"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": len(devices),
            "memory_peak_bytes": peak,
        },
        "window_s": window_s,
        "setup_phases_s": loop.phases,
    }
    if traced and trace.profile:
        result["device"]["busy_s"] = trace.profile["busy_s"]
        result["device"]["window_s"] = trace.profile["window_s"]
        result["breakdown"] = {"device_ops": trace.profile["device_ops"],
                               "idle_gaps": trace.profile["idle_gaps"]}
        result["event_busy_s"] = trace.profile["event_busy_s"]
    result["checks"] = {
        "mismatched_costs": {"value": checks["mismatched_costs"],
                             "limit": 0, "rule": "at most"},
        "judged_costs": {"value": checks["judged_costs"], "limit": 1,
                         "rule": "at least"},
        "judged_frames": {"value": checks["judged_frames"], "limit": 1,
                          "rule": "at least"},
    }
    return result
