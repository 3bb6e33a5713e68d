"""Inspection API: readbacks of pipeline intermediates for debugging.

Analog of the reference's debug/report switches and readback helpers
(reference: main.cpp:620-628 enableTerminalReport/reportReducedBoundaries/
reportCompleteBoundaries/reportReducedPrediction/reportDistortion with
targetCTU; main_aux_functions.h:405-688 readMemobjsIntoArray_*).  The cost
kernels never write these intermediates to device memory, so inspection
runs the stages of the plain pipeline for one (CTU, size group): on the
host, as the oracle, or on a device through the reduced-prediction kernel,
so that a device-only divergence is localizable per stage by diffing the
two modes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.constants import (
    BOUNDARY_SIZE,
    CTU_SIZE,
    GROUPS,
    REDUCED_PRED_SIZE,
    STRIDED_DISTORTIONS_PER_CTU,
)
from vvc_mip_gpu_tpu_torch.ops import mip_ops as ops
from vvc_mip_gpu_tpu_torch.ops.geometry import (
    GroupPlan,
    _group_plan,
    ctu_plan,
    padded_extent,
)
from vvc_mip_gpu_tpu_torch.ops.pred import mip_reduced_pred


def _samples(frame, device: torch.device) -> torch.Tensor:
    """[H, W] int16 samples on ``device``."""
    t = frame if torch.is_tensor(frame) else torch.as_tensor(
        np.asarray(frame))
    if t.ndim != 2:
        raise ValueError(f"frames must be [H, W], got {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int16)


def _stages(frame: torch.Tensor, ref: torch.Tensor, plan: GroupPlan,
            pred_fn) -> dict[str, torch.Tensor]:
    """Boundaries, reduced boundaries, reduced and (SizeId > 0) upsampled
    predictions of every CU of ``plan``'s lattice, CU axis last."""
    g = GROUPS[plan.group_index]
    sid = g.size_id
    hp, wp = padded_extent(plan.frame_w, plan.frame_h)
    ref_pad = ops.pad_reference(ref, ref[0], hp, wp)
    ref_t, ref_l = ops.gather_boundaries(ref_pad, plan, True)
    red_t = ops.reduce_boundary(ref_t, BOUNDARY_SIZE[sid])
    red_l = ops.reduce_boundary(ref_l, BOUNDARY_SIZE[sid])
    pred = pred_fn(red_t, red_l, sid)  # [2M, S, nCU]
    out = {"ref_t": ref_t, "ref_l": ref_l, "red_t": red_t, "red_l": red_l,
           "reduced_prediction": pred}
    if sid > 0:
        out["upsampled_prediction"] = ops.upsample_all(
            pred, ref_t, ref_l, g.width, g.height, REDUCED_PRED_SIZE[sid])
    return out


def _pick_ctu(t: torch.Tensor, plan: GroupPlan,
              ctu_idx: int) -> torch.Tensor:
    """[..., nCU] lattice tensor -> [..., cusPerCtu] of one CTU, in the
    CTU layout's CU order."""
    ctu_r, ctu_c = divmod(ctu_idx, plan.ctu_cols)
    lead = t.shape[:-1]
    t = t.reshape(*lead, plan.ctu_rows, plan.cu_rows, plan.ctu_cols,
                  plan.cu_cols)[..., ctu_r, :, ctu_c, :]
    return t.reshape(*lead, plan.cu_rows * plan.cu_cols)


def inspect_ctu(frame, ctu_idx: int, group_idx: int, ref_frame=None,
                from_engine: bool = False, device="cuda") -> dict:
    """All intermediates of one (CTU, size group): complete and reduced
    boundaries, reduced predictions of every mode and, for SizeId > 0, the
    upsampled predictions, with the CU axis first in the CTU layout's
    order (numpy int64; keys and shapes of the JAX package's
    ``inspect_ctu``).

    ``frame`` / ``ref_frame``: [H, W] samples (numpy or torch); the
    reference samples default to ``frame`` (pass the filtered frame for
    the alternative-samples regime).  ``from_engine=False`` recomputes the
    CTU's CUs on the host with the plain ops (the oracle).
    ``from_engine=True`` runs the gathers and boundary reduction of the
    group's whole-frame lattice on ``device``, the reduced prediction
    through ``mip_reduced_pred`` (the CUDA kernel on a CUDA device) and
    the upsampling, and reads back the CTU's part.  Out-of-frame CUs of
    partial CTUs hold edge-replicated values in both modes, as in the cost
    engine.
    """
    if not 0 <= group_idx < len(GROUPS):
        raise ValueError(f"group_idx {group_idx} out of range "
                         f"(0..{len(GROUPS) - 1})")
    g = GROUPS[group_idx]
    device = torch.device(device if from_engine else "cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "inspect_ctu: no CUDA device is available; pass device='cpu' "
            "to run the readback on the CPU")
    frame = _samples(frame, device)
    ref = frame if ref_frame is None else _samples(ref_frame, device)
    if ref.shape != frame.shape:
        raise ValueError("ref_frame must have the frame's shape")
    fh, fw = frame.shape
    plan = _group_plan(group_idx, fw, fh)
    one = ctu_plan(plan, ctu_idx)  # checks ctu_idx
    if from_engine:
        vals = {k: _pick_ctu(v, plan, ctu_idx) for k, v in
                _stages(frame, ref, plan, mip_reduced_pred).items()}
    else:
        vals = _stages(frame, ref, one, mip_reduced_pred.plain)
    vals = {k: v.movedim(-1, 0).cpu().numpy().astype(np.int64)
            for k, v in vals.items()}
    r = REDUCED_PRED_SIZE[g.size_id]
    vals["reduced_prediction"] = vals["reduced_prediction"].reshape(
        -1, g.total_modes, r, r)
    positions = np.stack([np.tile(one.xs, len(one.ys)),
                          np.repeat(one.ys, len(one.xs))], axis=1)
    return {"group": g.name, "positions": positions, **vals}


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def report_target_ctu(min_sad_had, frame_width: int, ctu_idx: int,
                      sad=None, satd=None, file=None) -> None:
    """Print the distortion table of one CTU (analog of the reference's
    reportTargetDistortionValues_ALL, main_aux_functions.h:690-733).
    Cost tensors: [nCTU, 97840], numpy or torch."""
    file = file or sys.stdout
    ctu_cols = -(-frame_width // CTU_SIZE)
    ctu_x = (ctu_idx % ctu_cols) * CTU_SIZE
    ctu_y = (ctu_idx // ctu_cols) * CTU_SIZE
    print(f"=== DISTORTION, CTU {ctu_idx} @ ({ctu_x},{ctu_y}) ===", file=file)
    print("cuSizeName,CU,Mode,SAD,SATD,minSadHad", file=file)
    slab = _host(min_sad_had[ctu_idx]).tolist()
    sad_slab = None if sad is None else _host(sad[ctu_idx]).tolist()
    satd_slab = None if satd is None else _host(satd[ctu_idx]).tolist()
    for g in GROUPS:
        start = int(STRIDED_DISTORTIONS_PER_CTU[g.index])
        m = g.total_modes
        for cu in range(g.cus_per_ctu):
            for mode in range(m):
                i = start + cu * m + mode
                s = "-" if sad_slab is None else sad_slab[i]
                t = "-" if satd_slab is None else satd_slab[i]
                print(f"ALL_{g.name},{cu},{mode},{s},{t},{slab[i]}",
                      file=file)
