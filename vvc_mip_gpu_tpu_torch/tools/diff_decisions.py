"""Diff two decisions-log CSVs, with numpy and the port's C reader.

The port's counterpart of the repository's tools/diff_decisions.py, which
needs pandas: the same arguments, identity columns, printed lines and
exit codes, and no pandas, so that it runs where the port runs.  The
CSVs are read through the C table reader of csrc/io_native.c
(io/native.py ``read_table_csv``; a 1920x1080 frame is ~13.2 M rows).
Every column is an integer but cuSizeName, as the decisions and
target-CTU CSVs of the reference, the JAX package and the port have it.

Usage:
    python -m vvc_mip_gpu_tpu_torch.tools.diff_decisions a.csv b.csv
        [--fields minSadHad] [--ignore-invalid WxH] [--limit N]

Rows are aligned on their identity columns (both files sorted by POC and
the identity columns, stably, when they have a POC column), then each
field is compared.  ``--ignore-invalid WxH``: mask rows whose CU extends
beyond the given frame (the reference leaves stale buffer contents for
out-of-frame CUs, intra.cl:96-98, the engine computes them from
edge-replicated samples and the golden model from clipped coordinates:
those rows legitimately differ).

Exit code 0 = equal (within the compared fields), 1 = differences.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from vvc_mip_gpu_tpu_torch.io import native

KEYS = ["CTU", "cuSizeName", "W", "H", "CU", "X", "Y", "Mode"]
TEXT_COLUMNS = ("cuSizeName",)


def read(path: str) -> dict[str, np.ndarray]:
    """{column: values} of one CSV in header and file order, int64 or
    bytes."""
    with open(path, newline="") as f:
        names = f.readline().rstrip("\r\n").split(",")
    missing = [k for k in KEYS if k not in names]
    if missing:
        raise SystemExit(f"{path}: missing identity columns {missing}")
    return dict(zip(names, native.read_table_csv(
        path, [name in TEXT_COLUMNS for name in names])))


def load(path: str) -> dict[str, np.ndarray]:
    """``read``, sorted stably by POC and the identity columns when the
    CSV has POC."""
    table = read(path)
    if "POC" in table:
        # np.lexsort sorts by its last key first; text by its bytes, as
        # pandas sorts ASCII strings
        keys = [np.unique(table[k], return_inverse=True)[1]
                if table[k].dtype.kind == "S" else table[k]
                for k in ["POC"] + KEYS]
        order = np.lexsort(keys[::-1])
        table = {name: col[order] for name, col in table.items()}
    return table


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--fields", nargs="+",
                   default=["SAD", "SATD", "minSadHad"])
    p.add_argument("--ignore-invalid", default=None, metavar="WxH",
                   help="mask CUs extending beyond this frame size")
    p.add_argument("--limit", type=int, default=10,
                   help="mismatching rows to print per field")
    args = p.parse_args(argv)

    a, b = load(args.a), load(args.b)
    n_a, n_b = len(a["CTU"]), len(b["CTU"])
    if n_a != n_b:
        print(f"row-count mismatch: {n_a} vs {n_b}")
        return 1
    for k in KEYS:
        if not (a[k] == b[k]).all():
            bad = np.nonzero(a[k] != b[k])[0][:3]
            print(f"identity column {k} differs at rows {bad.tolist()} — "
                  "not the same schema/order; aborting")
            return 1

    mask = np.ones(n_a, bool)
    if args.ignore_invalid:
        w, h = (int(v) for v in args.ignore_invalid.lower().split("x"))
        mask = (a["X"] + a["W"] <= w) & (a["Y"] + a["H"] <= h)
        print(f"comparing {int(mask.sum())}/{n_a} in-frame rows")

    rc = 0
    for f in args.fields:
        if f not in a or f not in b:
            print(f"{f}: absent, skipped")
            continue
        av, bv = a[f].astype(np.int64), b[f].astype(np.int64)
        mism = (av != bv) & mask
        n = int(mism.sum())
        if n == 0:
            print(f"{f}: OK ({int(mask.sum())} rows)")
            continue
        rc = 1
        print(f"{f}: {n} mismatches")
        idx = np.nonzero(mism)[0][:args.limit]
        cols = (["POC"] if "POC" in a else []) + KEYS
        for i in idx:
            ident = ",".join(_text(a[c][i]) for c in cols)
            print(f"  [{ident}] {av[i]} != {bv[i]}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
