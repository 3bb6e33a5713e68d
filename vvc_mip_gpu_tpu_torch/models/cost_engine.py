"""The full-frame MIP mode-search cost engine.

Computes, for every candidate CU of every size group in every CTU and every
(transposed and non-transposed) MIP mode, the SAD / SATD / minSadHad costs
(reference: main.cpp:678-1241, the initBoundaries -> MIP_ReducedPred ->
upsampleDistortion pipeline).

CUs are batched by shape class: one call per class covers every CU of that
(width, height, SizeId) across all alignment groups, CTUs and frames of a
batch.  On a CUDA device each call is one launch of a hand-written kernel
(ops/mip_cost.py) that writes its costs straight into the reference
strided layout; on the CPU the same calls run the kernels' plain PyTorch
versions.  All arithmetic is exact int32.

Out-of-frame CUs (partial CTUs at the bottom/right frame edges) are computed
from edge-replicated samples — deterministic, documented values — and
flagged invalid in the validity mask.  The reference leaves undefined buffer
contents for these CUs (intra.cl:96-98), so only valid CUs are comparable
with it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch import mip_weights
from vvc_mip_gpu_tpu_torch.constants import (
    GROUPS,
    STRIDED_DISTORTIONS_PER_CTU,
    num_ctus,
)
from vvc_mip_gpu_tpu_torch.ops.geometry import ClassPlan, class_plans, cu_table
from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS, CostKernel
from vvc_mip_gpu_tpu_torch.utils.timing import span

PER_CTU = int(STRIDED_DISTORTIONS_PER_CTU[-1])  # 97840


@dataclasses.dataclass
class FrameCosts:
    """Cost tensors in the reference's strided per-CTU layout.

    Index within a CTU slab: STRIDED_DISTORTIONS_PER_CTU[group] +
    cu * 2*num_modes + mode (reference: intra.cl:1144-1148); shape
    [nCTU, 97840], with a leading batch axis from ``compute_batch``.
    """

    sad: torch.Tensor | None
    satd: torch.Tensor | None
    min_sad_had: torch.Tensor
    valid: torch.Tensor  # bool, same layout; False for out-of-frame CUs


@dataclasses.dataclass(frozen=True)
class ClassRun:
    """What one shape class's kernel call needs, resident on a device."""

    plan: ClassPlan
    table: torch.Tensor  # int32 [nCU, 3], geometry.cu_table
    weights: torch.Tensor  # int32 [M, S, C] of the class's SizeId
    kernel: CostKernel


@functools.cache
def class_runs(width: int, height: int,
               device: torch.device) -> tuple[ClassRun, ...]:
    """Per-class CU tables and weights for a frame size, built once with
    numpy and kept on ``device``."""
    weights = mip_weights.weights_from_numpy(mip_weights.matrices(), device)
    return tuple(
        ClassRun(cplan, torch.from_numpy(cu_table(cplan)).to(device),
                 weights[cplan.shape.size_id], KERNELS[cplan.shape.size_id])
        for cplan in class_plans(width, height))


def _as_samples(frame: torch.Tensor) -> torch.Tensor:
    """int16 contiguous samples (10-bit luma fits; storage only)."""
    return frame.to(torch.int16).contiguous()


def _run_classes(frame, ref, halo_row, is_top: bool, width: int, height: int,
                 max_performance: bool, classes=None,
                 timed: bool = False) -> list[torch.Tensor]:
    """Run the selected classes (indices into ``class_plans``; all by
    default) over [B, H, W] frames.  Returns ``[msh]`` or ``[sad, satd]``,
    each int32 [B, nCTU, 97840]; the columns outside the selected
    classes' ``_columns`` are left unwritten.  Span ``engine.search`` is
    the whole call, the samples' int16 casts included; ``engine.launch``
    only the class calls, and with ``timed`` also their time on the
    card."""
    with span("engine.search"):
        share_ref = ref is frame
        frame = _as_samples(frame)
        ref = frame if share_ref else _as_samples(ref)
        halo_row = _as_samples(halo_row)
        if frame.ndim != 3 or tuple(frame.shape[1:]) != (height, width):
            raise ValueError(f"frames must be [B, {height}, {width}], got "
                             f"{tuple(frame.shape)}")
        runs = class_runs(width, height, frame.device)
        if classes is not None:
            runs = tuple(runs[i] for i in classes)
        n_ctu = num_ctus(width, height)[2]
        outs = [torch.empty((frame.shape[0], n_ctu, PER_CTU),
                            dtype=torch.int32, device=frame.device)
                for _ in range(1 if max_performance else 2)]
        with span("engine.launch", frame.device if timed else None):
            for run in runs:
                run.kernel(frame, ref, halo_row, is_top, run.plan, run.table,
                           run.weights, outs)
        return outs


def _columns(width: int, height: int, classes=None) -> list[slice]:
    """The column ranges of the strided layout that the selected classes
    (indices into ``class_plans``; all by default) write in
    ``_run_classes``' outputs: one per alignment group of their plans."""
    plans = class_plans(width, height)
    if classes is not None:
        plans = tuple(plans[i] for i in classes)
    s = STRIDED_DISTORTIONS_PER_CTU
    return [slice(int(s[gp.group_index]), int(s[gp.group_index + 1]))
            for cplan in plans for gp in cplan.groups]


def _combine(sad, satd, device=None) -> torch.Tensor:
    """minSadHad = min(2 SAD, SATD) of every cost (reference: intra.cl:
    1122-1168, which forms it inside its kernel), as span
    ``engine.combine``; ``device``: a CUDA device whose current stream
    the span also times."""
    with span("engine.combine", device):
        return torch.minimum(2 * sad, satd)


def compute_ext(frame, ref, halo_row, is_top: bool, width: int, height: int,
                max_performance: bool = False, timed: bool = False):
    """Cost computation against a halo-extended reference slab.

    ``frame``: [B, height, width] distortion-target slabs; ``ref``: the
    boundary-sample source (pass the SAME OBJECT as ``frame`` for the
    original-samples regime); ``halo_row``: [B, width], the sample row
    above each slab (from the neighbouring shard in a spatially split
    frame; any row for the frame's top slab).  ``is_top`` marks slabs that
    hold the frame's top row.  Returns (sad, satd, min_sad_had), each
    [B, nCTU, 97840]; with ``max_performance`` (the reference's
    MAX_PERFORMANCE_DIST, main_aux_functions.h:1) sad/satd are None and
    only minSadHad is computed.  ``timed``: spans ``engine.launch`` and
    ``engine.combine`` also time the class calls and the minSadHad
    combine on the card, with a pair of CUDA events each.
    """
    outs = _run_classes(frame, ref, halo_row, is_top, width, height,
                        max_performance, timed=timed)
    if max_performance:
        return None, None, outs[0]
    sad, satd = outs
    return sad, satd, _combine(sad, satd, sad.device if timed else None)


@functools.cache
def _validity_mask(width: int, height: int,
                   padded_height: int | None = None) -> np.ndarray:
    """Static [nCTU, 97840] bool mask of the CUs fully inside the
    ``width`` x ``height`` frame, over the CTUs of a frame padded to
    ``padded_height`` rows (default ``height``; the sharded engine pads
    to whole CTU rows of every band)."""
    padded_height = height if padded_height is None else padded_height
    out = np.zeros((num_ctus(width, padded_height)[2], PER_CTU), bool)
    for cplan in class_plans(width, padded_height):
        for gp in cplan.groups:
            g = GROUPS[gp.group_index]
            valid = ((gp.ys + g.height <= height)[:, None]
                     & (gp.xs + g.width <= width)[None, :])
            v = np.repeat(gp.to_ctu_layout(valid), g.total_modes, axis=1)
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


class MipCostEngine:
    """Full-frame MIP cost search for a fixed frame size.

    >>> engine = MipCostEngine(1920, 1080)        # on the CUDA device
    >>> costs = engine(frame)                     # original-sample regime
    >>> costs = engine(frame, filtered_frame)     # alternative-sample regime
    >>> costs = engine.compute_batch(frames)      # [B, H, W] in one pass
    """

    def __init__(self, width: int, height: int,
                 max_performance: bool = False, device="cuda"):
        """``max_performance`` mirrors the reference's MAX_PERFORMANCE_DIST
        (main_aux_functions.h:1): only minSadHad is computed and
        FrameCosts.sad/satd are None.  ``device``: where the search runs;
        "cpu" runs the kernels' plain versions."""
        if width % 4 or height % 4:
            raise ValueError("frame dimensions must be multiples of 4")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MipCostEngine: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.width = width
        self.height = height
        self.max_performance = max_performance
        self.device = device
        self.n_ctus = num_ctus(width, height)[2]
        self._valid = torch.from_numpy(_validity_mask(width, height)).to(
            device)

    def _costs(self, frames, ref_frames, timed=False) -> FrameCosts:
        frames = torch.as_tensor(frames, device=self.device)
        if ref_frames is None:
            ref_frames = frames
        else:
            ref_frames = torch.as_tensor(ref_frames, device=self.device)
        sad, satd, msh = compute_ext(
            frames, ref_frames, ref_frames[:, 0], True, self.width,
            self.height, max_performance=self.max_performance, timed=timed)
        return FrameCosts(sad=sad, satd=satd, min_sad_had=msh,
                          valid=self._valid.expand(msh.shape))

    def __call__(self, frame, ref_frame=None) -> FrameCosts:
        """frame: [H, W] integer luma samples (10-bit).  ref_frame: the
        boundary-sample source; defaults to ``frame`` (pass the low-pass
        filtered frame for the alternative-samples regime,
        reference: main.cpp:818-822)."""
        frame = torch.as_tensor(frame, device=self.device)[None]
        if ref_frame is not None:
            ref_frame = torch.as_tensor(ref_frame, device=self.device)[None]
        c = self._costs(frame, ref_frame)
        return FrameCosts(
            *(None if t is None else t[0]
              for t in (c.sad, c.satd, c.min_sad_had, c.valid)))

    def compute_batch(self, frames, ref_frames=None) -> FrameCosts:
        """Batched search: [B, H, W] frames in one pass (one kernel launch
        per shape class for the whole batch).  FrameCosts fields gain a
        leading batch axis.  Under a profiler, spans ``engine.launch``
        and (full report) ``engine.combine`` also hold the class calls'
        and the combine's time on the card."""
        return self._costs(frames, ref_frames, timed=True)
