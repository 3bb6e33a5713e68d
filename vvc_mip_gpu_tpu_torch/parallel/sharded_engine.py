"""Sharded multi-device MIP cost engine: frames x CTU-row bands.

Shards a batch of frames over the ``data`` axis of a mesh (mesh.py) and
each frame's CTU rows over the ``space`` axis.  One process drives every
shard: shard (d, s) takes frames ``d*B/n_data ...`` and rows
``s*local_h ...`` onto its device and runs the cost kernels there
(``compute_ext``) on a stream of its own.  The only data that crosses
shards is a one-row halo of reference samples, band s-1's last row copied
to band s's device (boundary extraction reads the row above each CTU,
reference: intra.cl:76), and the gather of the cost tensors onto the first
shard's device.  Bit-identical to the single-device engine.

Frame heights that are not multiples of ``space * 128`` are padded by edge
replication; the padded CUs are flagged invalid in the validity mask exactly
like the single-device engine's out-of-frame CUs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.constants import (
    CTU_SIZE,
    GROUPS,
    STRIDED_DISTORTIONS_PER_CTU,
    num_ctus,
)
from vvc_mip_gpu_tpu_torch.models.cost_engine import FrameCosts, compute_ext
from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans
from vvc_mip_gpu_tpu_torch.parallel.mesh import (
    fork,
    join,
    on_stream,
    shard_stream,
)


def _padded_height(height: int, n_space: int) -> int:
    unit = CTU_SIZE * n_space
    return -(-height // unit) * unit


@functools.cache
def _validity_mask_np(width: int, true_height: int, padded_height: int):
    """[nCTU_padded, DIST_TOTAL] bool — CU fully inside the true frame."""
    out = np.zeros((num_ctus(width, padded_height)[2],
                    int(STRIDED_DISTORTIONS_PER_CTU[-1])), bool)
    for cplan in class_plans(width, padded_height):
        for gp in cplan.groups:
            g = GROUPS[gp.group_index]
            valid = ((gp.ys + g.height <= true_height)[:, None]
                     & (gp.xs + g.width <= width)[None, :])
            v = gp.to_ctu_layout(valid)
            v = np.repeat(v, g.total_modes, axis=1)
            start = int(STRIDED_DISTORTIONS_PER_CTU[g.index])
            out[:, start:start + v.shape[1]] = v
    return out


def as_frames(frames) -> torch.Tensor:
    """Frames as a tensor: a tensor stays where it is; a numpy array
    becomes an int16 host tensor (10-bit samples: the kernels' type, half
    the bytes of an upload in int32)."""
    if torch.is_tensor(frames):
        return frames
    return torch.from_numpy(np.ascontiguousarray(frames, dtype=np.int16))


def _cat(tensors: list[torch.Tensor], dim: int) -> torch.Tensor:
    return tensors[0] if len(tensors) == 1 else torch.cat(tensors, dim)


class ShardedMipCostEngine:
    """Multi-device MIP cost search over a batch of frames.

    >>> mesh = make_mesh(n_data, n_space)
    >>> engine = ShardedMipCostEngine(1920, 1080, mesh)
    >>> costs = engine(frames)   # frames: [B, H, W], B % n_data == 0
    """

    def __init__(self, width: int, height: int, mesh: np.ndarray,
                 max_performance: bool = False):
        """``mesh``: an [n_data, n_space] grid of devices (mesh.make_mesh).
        ``max_performance`` mirrors the reference's MAX_PERFORMANCE_DIST:
        only minSadHad is computed and gathered; FrameCosts.sad/satd are
        None."""
        if width % 4 or height % 4:
            raise ValueError("frame dimensions must be multiples of 4")
        if mesh.ndim != 2:
            raise ValueError(f"mesh must be [n_data, n_space], got shape "
                             f"{mesh.shape}")
        self.width = width
        self.height = height
        self.mesh = mesh
        self.n_data, self.n_space = mesh.shape
        self.max_performance = max_performance
        self.padded_height = _padded_height(height, self.n_space)
        self.local_height = self.padded_height // self.n_space
        self.n_ctus = num_ctus(width, self.padded_height)[2]
        self._streams = {ds: shard_stream(dev)
                         for ds, dev in np.ndenumerate(mesh)}
        self._valid = torch.from_numpy(_validity_mask_np(
            width, height, self.padded_height)).to(mesh[0, 0])

    def pad_frames(self, frames) -> torch.Tensor:
        """Pad [B, H, W] frames to the sharding height by edge replication
        (on the frames' device)."""
        frames = as_frames(frames)
        if frames.ndim != 3 or tuple(frames.shape[1:]) != (self.height,
                                                           self.width):
            raise ValueError(f"frames must be [B, {self.height}, "
                             f"{self.width}], got {tuple(frames.shape)}")
        pad = self.padded_height - self.height
        if pad == 0:
            return frames
        return torch.cat([frames, frames[:, -1:].expand(-1, pad, -1)], 1)

    def __call__(self, frames, ref_frames=None) -> FrameCosts:
        """frames: [B, H, W] (B divisible by the data-axis size); numpy
        or a tensor on any device.  ``ref_frames``: the boundary-sample
        source (the filtered frames); defaults to ``frames``.  Returns
        FrameCosts of the padded height, [B, nCTU_padded, 97840], on the
        first shard's device; ``valid`` is [nCTU_padded, 97840]."""
        share = ref_frames is None
        frames = self.pad_frames(frames)
        refs = frames if share else self.pad_frames(ref_frames)
        if frames.shape[0] % self.n_data:
            raise ValueError(f"a batch of {frames.shape[0]} frames does not "
                             f"split over a data axis of {self.n_data}")
        if refs.shape != frames.shape:
            raise ValueError("ref_frames must have the frames' shape")
        per, lh = frames.shape[0] // self.n_data, self.local_height
        # Each shard's frame and reference slabs, on its device (uploads on
        # the device's current stream).
        slabs = {}
        for (d, s), dev in np.ndenumerate(self.mesh):
            rows = (slice(d * per, (d + 1) * per), slice(s * lh, (s + 1) * lh))
            fr = frames[rows].to(dev)
            slabs[d, s] = (fr, fr if share else refs[rows].to(dev))
        outs = {}
        for (d, s), dev in np.ndenumerate(self.mesh):
            fr, re = slabs[d, s]
            # Band s-1's last reference row, onto band s's device (a ring,
            # as a ppermute: band 0 gets the last band's row and ignores
            # it, is_top).  In the shared-reference regime the reference
            # is the frame.
            halo = slabs[d, (s - 1) % self.n_space][1][:, -1].to(dev)
            stream = self._streams[d, s]
            fork(stream, fr, re, halo)
            with on_stream(stream):  # re is fr when the reference is shared
                sad, satd, msh = compute_ext(
                    fr, re, halo, s == 0, self.width, lh,
                    max_performance=self.max_performance)
            outs[d, s] = ((msh,) if self.max_performance
                          else (sad, satd, msh))
            join(stream, *outs[d, s])
        # Gather on the first shard's device: bands along the CTU axis,
        # data rows along the batch axis.
        dev0 = self.mesh[0, 0]
        gathered = [
            _cat([_cat([outs[d, s][k].to(dev0) for s in range(self.n_space)],
                       1) for d in range(self.n_data)], 0)
            for k in range(len(outs[0, 0]))]
        if self.max_performance:
            sad = satd = None
            (msh,) = gathered
        else:
            sad, satd, msh = gathered
        return FrameCosts(sad=sad, satd=satd, min_sad_had=msh,
                          valid=self._valid)
