"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, loop

from conftest import REPO, make_tiny_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.fullmatch(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "frames_per_s", "host_frames_per_s", "latency_p50_ms",
        "latency_p95_ms", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    assert issubclass(harness.loop_class(c.traffic["entry"]), loop.Loop)
    entry = next(x for x in BENCH["configs"]
                 if x["name"] == next(w for w in BENCH["workloads"]
                                      if w["name"] == cell)["config"])
    assert c.config["reduced"] == entry["reduced"] == []
    assert c.config["source"] == entry["source"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))
        # the end-to-end metric it moves is one this cell reports
        assert m["moves"] in names


def test_files_are_named_from_names():
    for path in (REPO / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "vvc_mip_gpu_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        assert "vvc_mip_gpu_tpu_torch" not in _imports(path), path
    for name in ("roofline.py", "frames.py", "judge.py", "loop.py"):
        assert "vvc_mip_gpu_tpu_torch" not in _imports(
            REPO / "portbench" / name), name


DUMMY_LOOP = """
from portbench import loop
from portbench.judge import Kept
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine


class Loop(loop.Loop):
    def setup(self):
        self.engine = MipCostEngine(self.width, self.height,
                                    max_performance=True, device=self.device)
        self.warm_up()

    def step(self, i):
        k = i % self.pool_size
        with self.trace.span("dummy.search"):
            costs = self.engine.compute_batch(self.pool[k:k + 1])
        return Kept([k], {"min_sad_had": costs.min_sad_had})
"""


def test_new_files_need_no_harness_edit(tmp_path, cpu_platform):
    """A configuration, a traffic mix with a loop of its own and a
    per-layer metric added as files, with entries in BENCHMARK.json, run
    with no edit of the harness."""
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/jvet-b-1080p.json")
                     .read_text())
    cfg.update(name="dummy", width=192, height=132)
    (root / "portbench/configs/dummy.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "portbench/traffic/tiny_resident.json")
                    .read_text())
    tr.update(entry="dummy_loop", batch=1, pool_frames=2)
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(tr))
    (root / "portbench/loops/dummy_loop.py").write_text(DUMMY_LOOP)
    (root / "portbench/metrics/dummy_steps.py").write_text(
        "def read(trace):\n"
        "    return float(len(trace.host_ms('dummy.search')))\n")
    bench["configs"].append({"name": "dummy", "source": "test",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "dummy_steps", "unit": "steps", "better": "higher",
        "source": "program_span", "layer": "cost engine",
        "moves": "frames_per_s", "workloads": ["dummy-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("dummy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("dummy-cell", root)
    assert cell.config["width"] == 192
    result = harness.run(cell, 2**31 + 5, 0.5, True, ["cpu"], 0.0)
    assert result["correct"]
    assert result["metrics"]["dummy_steps"]["value"] >= 1


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "b1080-resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA card" in proc.stderr


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "b1080-resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
