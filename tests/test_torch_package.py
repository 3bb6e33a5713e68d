"""Package rules of the PyTorch/CUDA port: it stands alone (no JAX, nothing
of the JAX package, no pandas, which the card's machine lacks), its copied
tables equal the reference's, its entry points run on the card unless
asked for the CPU, and its CU tables cover the strided cost layout
exactly."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import vvc_mip_gpu_tpu.constants as jconst
from vvc_mip_gpu_tpu import mip_weights as jweights
from vvc_mip_gpu_tpu_torch import constants as tconst
from vvc_mip_gpu_tpu_torch import mip_weights as tweights
from vvc_mip_gpu_tpu_torch.models import cost_engine as tce
from vvc_mip_gpu_tpu_torch.ops import _build
from vvc_mip_gpu_tpu_torch.ops import geometry as tgeo
from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS, mip_cost_sid0

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vvc_mip_gpu_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and idle OpenMP threads would spin on cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = [m for m in _imported_modules(path)
              if m.split(".")[0] in ("jax", "jaxlib", "vvc_mip_gpu_tpu",
                                     "pandas")]
    assert not banned, f"{path.name} imports {banned}"


def test_chip_smoke_takes_its_op_model_from_the_roofline_tool():
    """One op model: chip_smoke.py's bounds come from tools/roofline.py,
    and it keeps no copy of ``class_ops``."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)}
    assert "class_ops" not in defined
    assert "vvc_mip_gpu_tpu_torch.tools" in set(
        _imported_modules(ROOT / "chip_smoke.py"))


def test_constants_match_reference():
    assert [(g.name, g.width, g.height, g.size_id, g.xs, g.ys)
            for g in tconst.GROUPS] == [
        (g.name, g.width, g.height, g.size_id, g.xs, g.ys)
        for g in jconst.GROUPS]
    np.testing.assert_array_equal(tconst.STRIDED_DISTORTIONS_PER_CTU,
                                  jconst.STRIDED_DISTORTIONS_PER_CTU)
    assert [(c.width, c.height, c.size_id, c.group_indices, c.cu_offsets)
            for c in tconst.shape_classes()] == [
        (c.width, c.height, c.size_id, c.group_indices, c.cu_offsets)
        for c in jconst.shape_classes()]
    for name in ("MIP_SHIFT_MATRIX", "MIP_OFFSET_MATRIX", "SAMPLE_MAX",
                 "VALUE_DC", "BOUNDARY_SIZE", "REDUCED_PRED_SIZE",
                 "PRED_MODES"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert tconst.num_ctus(1920, 1080) == jconst.num_ctus(1920, 1080)


def test_filter_and_resolution_tables_match_reference():
    assert tconst.AVAILABLE_FILTERS == jconst.AVAILABLE_FILTERS
    assert tconst.AVAILABLE_RES == jconst.AVAILABLE_RES
    for name in ("CONV_KERNELS_3x3", "CONV_KERNELS_5x5"):
        mine, ref = getattr(tconst, name), getattr(jconst, name)
        assert mine.dtype == ref.dtype, name
        np.testing.assert_array_equal(mine, ref, err_msg=name)


def test_cli_and_inspect_default_to_cuda(monkeypatch):
    """Without VVC_MIP_PLATFORM the CLI asks for cuda:<DeviceIndex>, and
    the inspect readback runs on "cuda" unless given another device."""
    from vvc_mip_gpu_tpu_torch import cli
    from vvc_mip_gpu_tpu_torch.models.inspect import inspect_ctu
    from vvc_mip_gpu_tpu_torch.utils.config import EngineConfig

    assert inspect_ctu.__defaults__[-1] == "cuda"
    monkeypatch.delenv("VVC_MIP_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.run_device(EngineConfig(device_index=1)) == torch.device(
        "cuda", 1)
    with pytest.raises(ValueError, match="DeviceIndex"):
        cli.run_device(EngineConfig(device_index=2))
    monkeypatch.setenv("VVC_MIP_PLATFORM", "cpu")
    assert cli.run_device(EngineConfig()).type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inspect_ctu(np.zeros((128, 128), np.int32), 0, 0, from_engine=True)


def test_weights_from_reference_equal_own_copy():
    from_ref = tweights.weights_from_numpy(jweights.matrices(), "cpu")
    own = tweights.weights_from_numpy(tweights.matrices(), "cpu")
    assert sorted(from_ref) == [0, 1, 2]
    for sid in range(3):
        assert from_ref[sid].dtype == torch.int32
        assert from_ref[sid].is_contiguous()
        assert torch.equal(from_ref[sid], own[sid])
        np.testing.assert_array_equal(own[sid].numpy(),
                                      jweights.padded_matrix(sid))


def test_engine_defaults_to_cuda_and_never_falls_back(monkeypatch):
    assert tce.MipCostEngine.__init__.__defaults__[-1] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tce.MipCostEngine(128, 128)
    assert tce.MipCostEngine(128, 128, device="cpu").device.type == "cpu"


def test_engine_inputs_on_the_cpu():
    """uint16 frames (synthetic_frames' type) give the same costs as int32
    frames; an empty batch gives empty costs."""
    from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames

    engine = tce.MipCostEngine(128, 128, max_performance=True, device="cpu")
    frames = synthetic_frames(1, 128, 128, seed=1)
    got = engine.compute_batch(frames).min_sad_had
    want = engine(frames[0].astype(np.int32)).min_sad_had
    assert torch.equal(got[0], want)
    empty = engine.compute_batch(np.zeros((0, 128, 128), np.int32))
    assert tuple(empty.min_sad_had.shape) == (0, 1, tce.PER_CTU)


@pytest.mark.parametrize("size", [(1920, 1080), (608, 192)])
def test_cu_tables_cover_the_strided_layout_once(size):
    """Every (CU, mode) entry of a frame's [nCTU, 97840] cost slab is
    written by exactly one row of exactly one class table, and each row's
    origin is its CU's lattice position."""
    width, height = size
    n_ctu = tconst.num_ctus(width, height)[2]
    hits = np.zeros(n_ctu * tconst.STRIDED_DISTORTIONS_PER_CTU[-1], np.int8)
    for cplan in tgeo.class_plans(width, height):
        table = tgeo.cu_table(cplan)
        assert table.dtype == np.int32
        assert len(table) == sum(g.n_rows * g.n_cols for g in cplan.groups)
        two_m = cplan.shape.total_modes
        hits += np.bincount((table[:, 2:3] + np.arange(two_m)).ravel(),
                            minlength=hits.size).astype(np.int8)
        ys = np.concatenate([np.repeat(g.ys, g.n_cols) for g in cplan.groups])
        xs = np.concatenate([np.tile(g.xs, g.n_rows) for g in cplan.groups])
        # the same (y, x) pairs: each pair as one int64 key, sorted
        assert np.array_equal(np.sort(table[:, 0] * 2 ** 20 + table[:, 1]),
                              np.sort(ys.astype(np.int64) * 2 ** 20 + xs))
    assert (hits == 1).all()


def test_wrapper_checks_its_inputs():
    run = tce.class_runs(128, 128, torch.device("cpu"))[16]
    frame = torch.zeros((1, 128, 128), dtype=torch.int16)
    out = torch.zeros((1, 1, tce.PER_CTU), dtype=torch.int32)
    args = (frame, frame, frame[:, 0].contiguous(), True, run.plan,
            run.table, run.weights)
    with pytest.raises(ValueError, match="frame"):
        mip_cost_sid0(frame.to(torch.int32), *args[1:], [out])
    with pytest.raises(ValueError, match="outs"):
        mip_cost_sid0(*args, [out[:, :, :10]])
    with pytest.raises(ValueError, match="SizeId"):
        KERNELS[1](*args, [out])
    with pytest.raises(ValueError, match="no kernel"):
        mip_cost_sid0(*(a.to("meta") if torch.is_tensor(a) else a
                        for a in args), [out.to("meta")])


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda p: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_libraries()
    with pytest.raises(ValueError, match="unknown kernel library"):
        _build.library_path("mip_nothing")


def test_library_names_follow_each_source_headers_and_flags(monkeypatch,
                                                              tmp_path):
    """Each source builds its own library, named by a hash of that source,
    the headers of csrc/ and the flags: editing one source, adding a
    header or changing a flag renames the libraries it concerns, so a
    stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _build.LIBRARIES:
        (csrc / f"{name}.cu").write_bytes((_build.CSRC / f"{name}.cu")
                                          .read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = {n: _build.library_path(n).name for n in _build.LIBRARIES}
    assert sorted(names) == ["mip_cost", "mip_filter", "mip_pred"]
    for name, lib in names.items():
        assert lib.startswith(f"{name}_") and lib.endswith(".so")
    (csrc / "mip_pred.cu").write_text(
        (csrc / "mip_pred.cu").read_text() + "// edited\n")
    assert _build.library_path("mip_pred").name != names["mip_pred"]
    assert _build.library_path("mip_cost").name == names["mip_cost"]
    edited = {n: _build.library_path(n).name for n in _build.LIBRARIES}
    (csrc / "common.cuh").write_text("#pragma once\n")
    for name in _build.LIBRARIES:
        assert _build.library_path(name).name != edited[name]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("mip_cost").name != edited["mip_cost"]
    # a library already built is loaded without running nvcc
    lib = _build.library_path("mip_pred")
    lib.parent.mkdir()
    lib.write_bytes(b"")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert _build.build_libraries(("mip_pred",)) == {"mip_pred": (lib, "")}
