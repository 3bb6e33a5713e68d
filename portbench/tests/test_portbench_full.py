"""The full report's cell: a tiny copy of ``b1080-full-resident`` (256x136
under the tiny ``resident`` mix) judged in all three fields, SAD, SATD
and minSadHad, and the combine's count at the cell's real size.

A SAD or SATD altered where minSadHad does not move (SATD raised where
2 SAD < SATD, SAD raised where SATD < 2 SAD) is seen only by a judge that
holds SAD and SATD too: the run has to come out not correct, while the
minSadHad comparison alone finds nothing.
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness, judge, roofline_combine
from vvc_mip_gpu_tpu_torch.models import cost_engine

from conftest import REPO, TINY, make_tiny_root

SEED = 2**31 + 7
CELL = "tiny-full-resident"


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    """The tiny copy of the benchmark with ``tiny-full-resident`` added,
    reporting every metric ``b1080-full-resident`` reports."""
    root = make_tiny_root(tmp_path_factory.mktemp("tiny-full"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench/configs/jvet-b-1080p-full.json")
                     .read_text())
    cfg.update(TINY, name="tiny-jvet-b-1080p-full")
    (root / "portbench/configs/tiny-jvet-b-1080p-full.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({
        "name": cfg["name"], "source": "test",
        "file": "portbench/configs/tiny-jvet-b-1080p-full.json",
        "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": cfg["name"],
                               "traffic": "tiny_resident", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "b1080-full-resident" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def judged(monkeypatch):
    """Each comparison the harness makes, also made on minSadHad alone."""
    seen = []
    compare = judge.compare

    def both(program, reference, valid, picks):
        out = compare(program, reference, valid, picks)
        seen.append({"fields": sorted(reference), "valid": int(valid.sum()),
                     "all": out, "min_sad_had": compare(
                         program, {"min_sad_had": reference["min_sad_had"]},
                         valid, picks)})
        return out

    monkeypatch.setattr(judge, "compare", both)
    return seen


def _run(root):
    return harness.run(harness.load_cell(CELL, root), SEED, 1.0, False,
                       ["cpu"], 0.0)


def test_sound_run_is_correct_in_three_fields(full_root, cpu_platform,
                                              judged):
    result = _run(full_root)
    assert result["correct"], result["checks"]
    assert result["checks"]["mismatched_costs"]["value"] == 0
    (seen,) = judged
    assert seen["fields"] == ["min_sad_had", "sad", "satd"]
    assert seen["valid"] > 0
    assert result["checks"]["judged_costs"]["value"] == 3 * seen["valid"]


def _raise_where(field, monkeypatch):
    """The kernels' ``field`` plane one higher on every in-frame cost where
    minSadHad does not move for it."""
    original = cost_engine._run_classes

    def altered(frame, ref, halo_row, is_top, width, height,
                max_performance, *args, **kwargs):
        outs = original(frame, ref, halo_row, is_top, width, height,
                        max_performance, *args, **kwargs)
        assert not max_performance
        sad, satd = outs
        valid = torch.from_numpy(
            cost_engine._validity_mask(width, height)).to(sad.device)
        if field == "satd":
            satd[(2 * sad < satd) & valid] += 1
        else:
            sad[(satd < 2 * sad) & valid] += 1
        return outs

    monkeypatch.setattr(cost_engine, "_run_classes", altered)


@pytest.mark.parametrize("field", ["satd", "sad"])
def test_altered_field_that_leaves_min_sad_had_is_not_correct(
        full_root, cpu_platform, monkeypatch, judged, field):
    _raise_where(field, monkeypatch)
    result = _run(full_root)
    assert not result["correct"]
    assert result["checks"]["mismatched_costs"]["value"] > 0
    assert result["failed"] > 0
    (seen,) = judged
    assert seen["min_sad_had"]["mismatched_costs"] == 0


def test_combine_count_at_1080p_batch_16():
    ops, nbytes = roofline_combine.combine_work(1920, 1080, 16)
    assert nbytes == 3 * 16 * 135 * 97840 * 4 == 2_536_012_800
    assert ops == 2 * 16 * 135 * 97840
    assert roofline_combine.combine_bound_ms(1920, 1080, 16) == \
        pytest.approx(2_536_012_800 / 3.35e12 * 1e3, rel=1e-12)
    assert round(roofline_combine.combine_bound_ms(1920, 1080, 16), 4) \
        == 0.7570
