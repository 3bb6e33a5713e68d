"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny cells (256x136: 2x2 CTUs, a bottom row of 8 samples) that the
program's plain path runs on the CPU in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"width": 256, "height": 136}
# tiny cell -> (configuration it shrinks, traffic it shrinks)
TINY_CELLS = {
    "tiny-resident": ("jvet-b-1080p", "resident"),
    "tiny-alt-resident": ("jvet-a-2160p-alt", "resident"),
    "tiny-alt-stream": ("jvet-a-2160p-alt", "stream"),
    "tiny-single": ("jvet-b-1080p", "single"),
}


def make_tiny_root(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with TINY_CELLS added, each
    reporting every metric its model cell reports."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    model = {w["name"]: w for w in bench["workloads"]}
    for cell, (config, traffic) in TINY_CELLS.items():
        cfg = json.loads(
            (REPO / "portbench/configs" / f"{config}.json").read_text())
        cfg.update(TINY, name=f"tiny-{config}")
        (tmp / "portbench/configs" / f"tiny-{config}.json").write_text(
            json.dumps(cfg))
        tr = json.loads(
            (REPO / "portbench/traffic" / f"{traffic}.json").read_text())
        tr.update(batch=min(tr["batch"], 2), pool_frames=4, warmup_steps=1)
        if tr["judge_ctus_per_frame"] != "all":
            tr["judge_ctus_per_frame"] = 2
        (tmp / "portbench/traffic" / f"tiny_{traffic}.json").write_text(
            json.dumps(tr))
        if not any(c["name"] == cfg["name"] for c in bench["configs"]):
            bench["configs"].append({
                "name": cfg["name"], "source": "test",
                "file": f"portbench/configs/tiny-{config}.json",
                "reduced": [], "why": "test"})
        bench["workloads"].append({
            "name": cell, "config": cfg["name"], "traffic": f"tiny_{traffic}",
            "chips": 1, "why": "test"})
        twin = next(n for n, w in model.items()
                    if (w["config"], w["traffic"]) == (config, traffic))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cpu_platform(monkeypatch):
    """The CLI's multi-device paths on the CPU (its own switch)."""
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
