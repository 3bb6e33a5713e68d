"""The port's multi-device engines (vvc_mip_gpu_tpu_torch.parallel) on the
CPU against the JAX package's, tolerance 0.

The pure functions (``factor_devices``, ``class_weights``,
``partition_classes``, ``_padded_height``, ``_validity_mask_np`` and the
multi-process ``frame_slice`` arithmetic) equal JAX's over grids of
inputs.  The sharded engine on a (2, 2) mesh of the CPU equals JAX's
ShardedMipCostEngine on the conftest's virtual 8-device mesh over the
whole padded tensors; with a distinct reference (so a halo taken from the
wrong frame would show) it equals the port's own MipCostEngine on the
edge-padded frames.  The latency engine with 3 parts equals JAX's
MipCostEngine.  Inputs are made with numpy from a seed and handed to both
sides.  The kernels on the card, under meshes and parts, are held in
test_torch_kernels.py (marker ``cuda``).
"""

import socket

import numpy as np
import pytest
import torch

import jax

from vvc_mip_gpu_tpu.models.cost_engine import MipCostEngine as JaxEngine
from vvc_mip_gpu_tpu.parallel import distributed as jdist
from vvc_mip_gpu_tpu.parallel import latency_engine as jlat
from vvc_mip_gpu_tpu.parallel import mesh as jmesh
from vvc_mip_gpu_tpu.parallel import sharded_engine as jshard
from vvc_mip_gpu_tpu_torch.io.frames import synthetic_frames
from vvc_mip_gpu_tpu_torch.models.cost_engine import MipCostEngine
from vvc_mip_gpu_tpu_torch.parallel import distributed as tdist
from vvc_mip_gpu_tpu_torch.parallel import latency_engine as tlat
from vvc_mip_gpu_tpu_torch.parallel import mesh as tmesh
from vvc_mip_gpu_tpu_torch.parallel import sharded_engine as tshard

CPU = torch.device("cpu")
FIELDS = ("sad", "satd", "min_sad_had", "valid")
# the JAX sharded-engine test's geometry: a partial bottom CTU row
W, H, B = 256, 200, 2
FRAMES = np.random.default_rng(3).integers(0, 1024, (B, H, W), dtype=np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_equal(exp, got, what, fields=FIELDS):
    for field in fields:
        e, g = getattr(exp, field), getattr(got, field)
        if e is None:
            assert g is None, f"{what}: {field} should be None"
            continue
        e = np.asarray(e).astype(np.int64)
        g = np.asarray(g).astype(np.int64)
        assert e.shape == g.shape, f"{what} {field}: {e.shape} vs {g.shape}"
        bad = e != g
        assert not bad.any(), (f"{what} {field}: {bad.sum()} mismatches at "
                               f"{np.argwhere(bad)[:5]}")


def test_factor_devices_matches_jax():
    for n_dev in range(1, 17):
        for n_frames in (None, *range(0, 20)):
            assert (tmesh.factor_devices(n_dev, n_frames)
                    == jmesh.factor_devices(n_dev, n_frames)), (n_dev,
                                                                n_frames)


def test_class_weights_and_partitions_match_jax():
    rng = np.random.default_rng(5)
    for width, height in ((1920, 1080), (3840, 2160), (608, 192), (128, 128)):
        weights = tlat.class_weights(width, height)
        assert weights == jlat.class_weights(width, height)
        for w in (weights, list(rng.random(len(weights)))):
            for n in (1, 2, 3, 4, 5, 8, 17, 32):
                assert (tlat.partition_classes(n, w)
                        == jlat.partition_classes(n, w)), (width, n)


def test_padded_height_and_validity_mask_match_jax():
    for height in (4, 100, 128, 200, 1080, 2160):
        for n_space in (1, 2, 3, 4, 8):
            assert (tshard._padded_height(height, n_space)
                    == jshard._padded_height(height, n_space))
    for width, height, n_space in ((256, 200, 2), (608, 192, 4),
                                   (132, 100, 1), (1920, 1080, 2)):
        padded = tshard._padded_height(height, n_space)
        np.testing.assert_array_equal(
            tshard._validity_mask_np(width, height, padded),
            jshard._validity_mask_np(width, height, padded))


def test_frame_slice_matches_jax(monkeypatch):
    """frame_slice and the per-process batch over process counts, ranks,
    data rows per process and frame counts; jax.process_count and
    jax.process_index, torch.distributed's world size and rank are
    monkeypatched."""
    for n_proc in (1, 2, 4):
        for rows_per_proc in (1, 2):
            n_data = n_proc * rows_per_proc
            monkeypatch.setattr(jax, "process_count", lambda: n_proc)
            monkeypatch.setattr(torch.distributed, "get_world_size",
                                lambda: n_proc)
            for rank in range(n_proc):
                monkeypatch.setattr(jax, "process_index", lambda: rank)
                monkeypatch.setattr(torch.distributed, "get_rank",
                                    lambda: rank)
                jr = jdist.DistributedRunner(
                    128, 128, jmesh.make_mesh(n_data, 1))
                tr = tdist.DistributedRunner(
                    128, 128, tmesh.make_mesh(n_data, 1, [CPU] * n_data))
                assert tr.engine.n_data == rows_per_proc
                for n_frames in range(1, 10):
                    assert (tr.frame_slice(n_frames)
                            == jr.frame_slice(n_frames)), (n_proc, rank)
                    assert (tr._local_batch(n_frames)
                            == jr._local_batch(n_frames))


def test_mesh_never_falls_back_to_the_cpu(monkeypatch):
    mesh = tmesh.make_mesh(2, 3, [CPU] * 7)
    assert mesh.shape == (2, 3) and all(d == CPU for d in mesh.ravel())
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        tmesh.make_mesh(2, 2, [CPU] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        tmesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlat.LatencyMipCostEngine(128, 128)


@pytest.fixture(scope="module")
def jax_sharded_costs():
    """JAX's ShardedMipCostEngine on the virtual (2, 2) mesh, full
    report: one compile."""
    costs = jshard.ShardedMipCostEngine(W, H, jmesh.make_mesh(2, 2))(FRAMES)
    return jshard.FrameCosts(*(np.asarray(getattr(costs, f))
                               for f in ("sad", "satd", "min_sad_had",
                                         "valid")))


def test_sharded_engine_matches_jax(jax_sharded_costs):
    engine = tshard.ShardedMipCostEngine(
        W, H, tmesh.make_mesh(2, 2, [CPU] * 4))
    got = engine(FRAMES)
    assert tuple(got.min_sad_had.shape) == (B, engine.n_ctus, 97840)
    assert engine.padded_height == 256
    _assert_equal(jax_sharded_costs, got, "sharded (2, 2)")


@pytest.mark.parametrize("n_data,n_space,max_performance", [(1, 2, False)])
def test_sharded_engine_distinct_reference(n_data, n_space,
                                           max_performance):
    """With a reference that differs from the frame, each band's halo must
    be the band above's last REFERENCE row: the sharded engine equals the
    port's MipCostEngine on the edge-padded frames and references, whole
    tensors, and its true CTUs' valid CUs equal the engine on the
    unpadded ones."""
    width = 128
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 1024, (n_data, H, width), dtype=np.int32)
    refs = rng.integers(0, 1024, (n_data, H, width), dtype=np.int32)
    engine = tshard.ShardedMipCostEngine(
        width, H,
        tmesh.make_mesh(n_data, n_space, [CPU] * (n_data * n_space)),
        max_performance=max_performance)
    got = engine(frames, refs)
    pad = engine.padded_height
    padded = MipCostEngine(width, pad, max_performance=max_performance,
                           device="cpu").compute_batch(
        engine.pad_frames(frames), engine.pad_frames(refs))
    fields = ("min_sad_had",) if max_performance else FIELDS[:3]
    _assert_equal(padded, got, f"({n_data}, {n_space}) vs padded", fields)
    np.testing.assert_array_equal(
        got.valid.numpy(), tshard._validity_mask_np(width, H, pad))
    true = MipCostEngine(width, H, max_performance=max_performance,
                         device="cpu").compute_batch(frames, refs)
    n_ctu = true.min_sad_had.shape[1]
    valid = true.valid[0]
    assert torch.equal(got.valid[:n_ctu], valid)
    for field in fields:
        a = getattr(got, field)[:, :n_ctu]
        assert torch.equal(a[:, valid], getattr(true, field)[:, valid]), field


def test_latency_engine_matches_jax():
    width, height = 256, 192
    frame = synthetic_frames(1, width, height)[0].astype(np.int32)
    exp = JaxEngine(width, height, max_performance=False)(frame)
    got = tlat.LatencyMipCostEngine(width, height, [CPU] * 3,
                                    max_performance=False)(frame)
    _assert_equal(exp, got, "latency, 3 parts")


def test_latency_engine_distinct_reference():
    """4 parts, max performance, a distinct reference: equal to the port's
    MipCostEngine, whole tensors."""
    width, height = 128, 128
    rng = np.random.default_rng(13)
    frame, ref = rng.integers(0, 1024, (2, height, width), dtype=np.int32)
    exp = MipCostEngine(width, height, max_performance=True,
                        device="cpu")(frame, ref)
    engine = tlat.LatencyMipCostEngine(width, height, [CPU] * 4)
    assert len(engine._parts) == 4
    got = engine(frame, ref)
    _assert_equal(exp, got, "latency, 4 parts")


def test_process_group_of_one():
    """The gloo runtime in this process alone: the global mesh, the
    all-gather and the runner's slice; then the group is shut down."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tdist.initialize(f"localhost:{port}", 1, 0)
    try:
        mesh = tdist.make_global_mesh(2, [CPU] * 4)
        assert mesh.shape == (2, 2)
        with pytest.raises(ValueError, match="must divide"):
            tdist.make_global_mesh(3, [CPU] * 4)
        got = tdist.process_allgather(np.arange(6).reshape(2, 3))
        np.testing.assert_array_equal(got, np.arange(6).reshape(1, 2, 3))
        runner = tdist.DistributedRunner(128, 128, mesh)
        assert runner.frame_slice(3) == range(0, 3)
        tdist.barrier()
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()
