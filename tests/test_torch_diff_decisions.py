"""The port's decisions diff (vvc_mip_gpu_tpu_torch/tools/diff_decisions.py,
numpy and the C table reader, no pandas) against the repository's
tools/diff_decisions.py (pandas) on the same CSV pairs: the same exit
code, or the same SystemExit message, and the same printed lines.  The
CSVs come from the port's CLI on the CPU: two equal 128x128 runs, and a
96x72 run of two frames (a partial CTU, 96 wide and 72 tall) with a
target-CTU CSV, which has a POC column (its first rows of each POC).
Then the C table reader against pandas' reader and on malformed tables.
No JAX compile."""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from vvc_mip_gpu_tpu_torch import cli
from vvc_mip_gpu_tpu_torch.io import native
from vvc_mip_gpu_tpu_torch.tools import diff_decisions as port_diff

ROOT = Path(__file__).resolve().parent.parent
TARGET_ROWS = 20000
_spec = importlib.util.spec_from_file_location(
    "pandas_diff_decisions", ROOT / "tools" / "diff_decisions.py")
pandas_diff = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pandas_diff)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(args, prefix) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(args + ["-l", str(prefix)]) == 0


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """{name: (path, its lines)}: two equal 128x128 decisions CSVs (no POC
    column) and a 96x72 run's frame 0 and the first TARGET_ROWS rows of
    each POC of its target-CTU CSV (POC column); "dir": a directory for
    the edited copies."""
    d = tmp_path_factory.mktemp("diff")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VVC_MIP_PLATFORM", "cpu")
        for name in ("a", "b"):
            _cli(["-f", "1", "-s", "128x128", "--Synthetic",
                  "--FullDistortion"], d / f"{name}_")
        _cli(["-f", "2", "-s", "96x72", "--Synthetic", "--FullDistortion",
              "--TargetCTU", "0"], d / "p_")
    header, *lines = (d / "p_target_ctu0.csv").read_text().splitlines()
    half = len(lines) // 2
    (d / "target.csv").write_text("\n".join(
        [header, *lines[:TARGET_ROWS], *lines[half:half + TARGET_ROWS]])
        + "\n")
    paths = {"a": d / "a_mip_decisions.csv", "b": d / "b_mip_decisions.csv",
             "partial": d / "p_mip_decisions_poc0.csv",
             "target": d / "target.csv"}
    out = {name: (path, path.read_text().splitlines())
           for name, path in paths.items()}
    out["dir"] = d
    return out


def _edited(src, dst: Path, edit) -> Path:
    """A copy of ``src`` (path, lines) whose data lines ``edit`` changed:
    it takes and returns the list of data lines."""
    header, *lines = src[1]
    dst.write_text("\n".join([header, *edit(list(lines))]) + "\n")
    return dst


def _bump(lines, at, column=-1, by=1):
    """``lines`` with field ``column`` of the lines ``at`` moved by
    ``by``."""
    for i in at:
        fields = lines[i].split(",")
        fields[column] = str(int(fields[column]) + by)
        lines[i] = ",".join(fields)
    return lines


def _out_of_frame(src, width: int, height: int) -> np.ndarray:
    """The data lines of ``src`` whose CU extends beyond the frame."""
    df = pd.read_csv(src[0])
    return np.flatnonzero((df.X + df.W > width) | (df.Y + df.H > height))


def _outcome(run):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = run()
        except SystemExit as err:
            rc = ("SystemExit", str(err.code))
    return rc, out.getvalue()


def _both(argv):
    """(port's outcome, pandas tool's outcome), each (exit code, stdout)."""
    port = _outcome(lambda: port_diff.main(argv))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["diff_decisions.py", *argv])
        theirs = _outcome(pandas_diff.main)
    return port, theirs


def _case(csvs, name):
    """(argv, expected exit code or None for a SystemExit) of one case,
    writing its edited copy."""
    d = csvs["dir"]
    a, b, partial, target = (csvs[k] for k in ("a", "b", "partial",
                                               "target"))
    rng = np.random.default_rng(7)
    frame = ["--ignore-invalid", "96x72"]
    if name == "equal runs":
        return [str(a[0]), str(b[0])], 0
    if name == "equal runs, one field":
        return [str(a[0]), str(b[0]), "--fields", "minSadHad"], 0
    if name == "costs changed":
        b2 = _edited(b, d / "costs.csv", lambda r: _bump(
            _bump(r, rng.choice(len(r), 12, replace=False)), [5, 9], -3))
        return [str(a[0]), str(b2), "--limit", "4"], 1
    if name == "identity column changed":
        b2 = _edited(b, d / "ident.csv", lambda r: _bump(r, [3, 700], 5))
        return [str(a[0]), str(b2)], 1
    if name == "row missing":
        b2 = _edited(b, d / "short.csv", lambda r: r[:-1])
        return [str(a[0]), str(b2)], 1
    if name == "field absent":
        return [str(a[0]), str(b[0]), "--fields", "SAD", "Cost"], 0
    if name == "identity column absent":
        b2 = d / "no_mode.csv"
        b2.write_text(b[0].read_text().replace("Mode,", "Mod,", 1))
        return [str(a[0]), str(b2)], None
    if name in ("--ignore-invalid, out-of-frame rows changed",
                "out-of-frame rows changed, not ignored"):
        oof = _out_of_frame(partial, 96, 72)
        p2 = _edited(partial, d / "oof.csv",
                     lambda r: _bump(r, oof[::50], by=-7))
        ignore = name.startswith("--ignore-invalid")
        return [str(partial[0]), str(p2), *(frame if ignore else [])], int(
            not ignore)
    if name == "--ignore-invalid, an in-frame row changed":
        oof = _out_of_frame(partial, 96, 72)
        inside = np.setdiff1d(np.arange(len(partial[1]) - 1), oof)
        p2 = _edited(partial, d / "inframe.csv", lambda r: _bump(
            _bump(r, oof[::80]), inside[1000:1001], -2))
        return [str(partial[0]), str(p2), *frame], 1
    if name == "POC rows shuffled":
        t2 = _edited(target, d / "shuffled.csv",
                     lambda r: [r[i] for i in rng.permutation(len(r))])
        return [str(target[0]), str(t2)], 0
    if name == "POC rows shuffled, costs changed":
        t2 = _edited(target, d / "shuffled.csv", lambda r: _bump(
            [r[i] for i in rng.permutation(len(r))], [0, 17, 900]))
        return [str(t2), str(target[0]), "--limit", "2"], 1
    raise KeyError(name)


CASES = ("equal runs", "equal runs, one field", "costs changed",
         "identity column changed", "row missing", "field absent",
         "identity column absent",
         "--ignore-invalid, out-of-frame rows changed",
         "out-of-frame rows changed, not ignored",
         "--ignore-invalid, an in-frame row changed", "POC rows shuffled",
         "POC rows shuffled, costs changed")


@pytest.mark.parametrize("name", CASES)
def test_port_diff_equals_pandas_diff(csvs, name):
    argv, rc = _case(csvs, name)
    port, theirs = _both(argv)
    assert port == theirs
    if rc is None:
        assert port[0][0] == "SystemExit" and "['Mode']" in port[0][1]
    else:
        assert port[0] == rc, port[1]
    assert port[1] or rc is None


def test_table_reader_equals_pandas(csvs):
    for path in (csvs["a"][0], csvs["target"][0]):
        df = pd.read_csv(path)
        cols = native.read_table_csv(
            path, [name == "cuSizeName" for name in df.columns])
        assert len(cols) == len(df.columns)
        for name, col in zip(df.columns, cols):
            if name == "cuSizeName":
                assert col.astype(str).tolist() == df[name].tolist()
            else:
                np.testing.assert_array_equal(col, df[name].to_numpy())
                assert col.dtype == np.int64


@pytest.mark.parametrize("text, rows_or_error", [
    ("a,b\n1,x\n\n-2,yy\r\n+3,z", [[1, -2, 3], [b"x", b"yy", b"z"]]),
    ("a,b\n", [[], []]),
    ("a,b\n1,x\n2\n", "data row 1: a field count"),
    ("a,b\n1,x\n2,y,3\n", "data row 1: a field count"),
    ("a,b\n1,x\n2.5,y\n", "data row 1, column 0: not an integer"),
    ("a,b\n,x\n", "data row 0, column 0: not an integer"),
    ("a,b\n1," + "w" * 32 + "\n", "data row 0, column 1: text longer"),
], ids=["blank line, CRLF, signs", "no rows", "too few fields",
        "too many fields", "a float", "an empty integer", "long text"])
def test_table_reader_rows_and_errors(tmp_path, text, rows_or_error):
    path = tmp_path / "t.csv"
    path.write_text(text)
    if isinstance(rows_or_error, str):
        with pytest.raises(ValueError, match=rows_or_error):
            native.read_table_csv(path, [False, True])
        return
    ints, texts = native.read_table_csv(path, [False, True])
    assert ints.tolist() == rows_or_error[0]
    assert texts.tolist() == rows_or_error[1]
