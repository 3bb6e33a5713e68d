"""The benchmark's op model of the MIP search and the filters, with fixed
peaks of one NVIDIA H100 SXM.

Counts what the functions need at given shapes, whichever kernels run
them, so a later change that fuses, splits or renames kernels leaves the
bound as it is.

Search, per shape class (h x w CU, 2M modes, r = reduced prediction
size), per frame: per sample and mode 1 (diff) + 2 (SAD: abs, accumulate)
+ 4 (SATD butterflies) + 2 (SATD abs, accumulate); 4 per upsampled sample
(r*w horizontal when r < w, h*w vertical when r < h or r < w); 4*r*r for
the prediction epilogue; 6 per (CU, mode).  Bytes per class: the batch's
int16 samples read once, the class's CU table (int32 [nCU, 3]) and its
SizeId's weights (int32 [M, S, C]) read once, one int32 cost per (frame,
CU, mode) written once.

Filter, per sample: a multiply and an add per tap, a rounding add and a
division; bytes: the batch read once in the type the filter is handed and
the filtered batch written once in the type it returns.

Peaks: 128 int32 results per clock per SM (CUDA C++ Programming Guide,
arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
1980 MHz, the H100 SXM's maximum SM clock; 3.35 TB/s of HBM3 (H100 SXM
data sheet).  A kernel that packs two 16-bit results into one 32-bit lane
could read above 100 % against this peak: the count then needs a recount.
"""

from __future__ import annotations

from portbench.reference.tables import (
    PRED_MODES,
    REDUCED_PRED_SIZE,
    mip_matrices,
    num_ctus,
    shape_classes,
)

INT32_OPS_PER_S = 128 * 132 * 1980e6
HBM_BYTES_PER_S = 3.35e12


def class_ops(h: int, w: int, r: int, two_m: int, n_cu: int) -> int:
    """Integer operations one class needs for one frame."""
    up = (4 * r * w if r < w else 0) + (4 * h * w if (r < h or r < w) else 0)
    return n_cu * two_m * ((1 + 2 + 4 + 2) * h * w + up + 4 * r * r + 6)


def class_work(width: int, height: int, batch: int) -> list[dict]:
    """Per shape class: {"class": "WxH", "n_cu", "ops", "bytes"} of one
    batch."""
    n_ctus = num_ctus(width, height)[2]
    rows = []
    for w, h, size_id, cus_per_ctu in shape_classes():
        n_cu = cus_per_ctu * n_ctus
        two_m = 2 * PRED_MODES[size_id]
        r = REDUCED_PRED_SIZE[size_id]
        rows.append({
            "class": f"{w}x{h}", "n_cu": n_cu,
            "ops": batch * class_ops(h, w, r, two_m, n_cu),
            "bytes": (batch * width * height * 2 + n_cu * 3 * 4
                      + mip_matrices()[size_id].size * 4
                      + batch * n_cu * two_m * 4)})
    return rows


def bound_ms(ops: float, nbytes: float) -> float:
    """The least milliseconds for that work: ops or bytes, whichever
    bounds."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def search_bound_ms(width: int, height: int, batch: int) -> float:
    rows = class_work(width, height, batch)
    return bound_ms(sum(r["ops"] for r in rows), sum(r["bytes"] for r in rows))


def filter_bound_ms(filter_type: str, width: int, height: int, batch: int,
                    in_bytes: int = 4, out_bytes: int = 4) -> float:
    k = 5 if "5x5" in filter_type else 3
    taps = k * k if "2d" in filter_type else 2 * k
    samples = batch * width * height
    return bound_ms(samples * (2 * taps + 2),
                    samples * (in_bytes + out_bytes))
