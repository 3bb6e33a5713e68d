"""The comparison that decides ``correct``: the program's costs against the
plain reference's, on the valid CUs of CTUs drawn from the seed.

A run hands over the outputs it kept from its window (``Kept``: the pool
frames of one batch or frame, and the program's cost arrays for them).
For each frame of each, ``select`` draws the CTUs to judge (every CTU
where the traffic asks for whole frames), always with one of the partial
bottom row and right column where the frame has them.  The reference
works the costs of those CTUs out again from the original frames, and
the filtered frames from the originals where the configuration filters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import costs as ref_costs
from portbench.reference import filters as ref_filters
from portbench.reference.tables import CTU_SIZE, num_ctus

FIELDS_MAX_PERFORMANCE = ("min_sad_had",)
FIELDS_FULL = ("sad", "satd", "min_sad_had")


@dataclasses.dataclass
class Kept:
    """Outputs of one step of the window: ``frames`` are pool indices, and
    each field is an array-like [len(frames), nCTU, 97840] (a device
    tensor or a host array)."""

    frames: list[int]
    fields: dict


def select(kept: list[Kept], width: int, height: int, ctus_per_frame,
           seed: int) -> list[tuple[int, int, int, int]]:
    """(kept index, row in it, pool frame, CTU) of every CTU to judge;
    ``ctus_per_frame`` is a count or "all"."""
    cols, rows, n_ctu = num_ctus(width, height)
    rng = np.random.default_rng([seed % (1 << 63), 0x7ab1e])
    edge = [c for c in range(n_ctu)
            if (height % CTU_SIZE and c // cols == rows - 1)
            or (width % CTU_SIZE and c % cols == cols - 1)]
    out = []
    for k, step in enumerate(kept):
        for row, frame in enumerate(step.frames):
            if ctus_per_frame == "all" or ctus_per_frame >= n_ctu:
                chosen = range(n_ctu)
            else:
                first = [int(rng.choice(edge))] if edge else []
                rest = rng.permutation(
                    [c for c in range(n_ctu) if c not in first])
                chosen = sorted(first + [int(c) for c in
                                         rest[:ctus_per_frame - len(first)]])
            out.extend((k, row, frame, c) for c in chosen)
    return out


def reference_rows(pool, picks, filter_spec, fields, device,
                   dtype=torch.int64):
    """({field: [P, 97840]}, valid [P, 97840]) of the picked CTUs, by the
    plain reference in ``dtype`` on ``device``.  ``pool``: the frames
    (a tensor or a host array, indexed by pool frame); ``filter_spec``:
    (filter type, kernel index) or None."""
    frames = sorted({p[2] for p in picks})
    where = {f: i for i, f in enumerate(frames)}
    sub = torch.stack([torch.as_tensor(pool[f]) for f in frames]).to(device)
    refs = None
    if filter_spec is not None:
        refs = torch.cat([ref_filters.filter_frames(sub[i:i + 1], *filter_spec,
                                                    dtype=dtype)
                          for i in range(len(frames))])
    sad, satd, msh, valid = ref_costs.ctu_costs(
        sub, refs, [where[p[2]] for p in picks], [p[3] for p in picks],
        dtype=dtype)
    rows = {"sad": sad, "satd": satd, "min_sad_had": msh}
    return {f: rows[f] for f in fields}, valid


def program_rows(kept: list[Kept], picks, fields, device):
    """{field: [P, 97840] int64} of the picked CTUs from the kept
    outputs, on ``device``."""
    out = {}
    for f in fields:
        rows = []
        for k, row, _, ctu in picks:
            rows.append(torch.as_tensor(kept[k].fields[f][row][ctu]).to(
                device, torch.int64))
        out[f] = torch.stack(rows)
    return out


def compare(program: dict, reference: dict, valid, picks) -> dict:
    """Mismatched valid entries, judged valid entries and the frames with
    any mismatch."""
    bad = torch.zeros_like(valid)
    for f, ref in reference.items():
        bad |= (program[f] != ref.to(torch.int64)) & valid
    per_pick = bad.any(dim=1).cpu().numpy()
    failed_frames = {(p[0], p[1]) for p, b in zip(picks, per_pick) if b}
    return {"mismatched_costs": int(bad.sum()),
            "judged_costs": int(valid.sum()) * len(reference),
            "failed_frames": len(failed_frames),
            "judged_frames": len({(p[0], p[1]) for p in picks})}
