"""The port's C CSV library (csrc/io_native.c, bound by io/native.py and
built with the host C compiler) against its numpy oracles: the frame
reader (every validation, the same ValueError in the same cases), the
frame writer (np.savetxt's bytes) and the decisions writer in every
variant (also against the JAX package's export, byte for byte).  Then
the build rules: a hashed library name, no compiler means an error and
never the numpy path, and two processes building at once."""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vvc_mip_gpu_tpu.io import export as jexport
from vvc_mip_gpu_tpu_torch.io import export as texport
from vvc_mip_gpu_tpu_torch.io import frames as tframes
from vvc_mip_gpu_tpu_torch.io import native
from vvc_mip_gpu_tpu_torch.ops import _build

PER_CTU = texport.DIST_PER_CTU
ROOT = Path(__file__).resolve().parent.parent
# np.fromstring warns where it stops at unmatched text; the C reader
# stops at the same place, silently
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _read_both(path, width, height, n_frames, start=0):
    """The C and numpy readers' outcomes: ("ok", samples) or ("error",
    message) each."""
    out = []
    for read in (tframes.read_frames_csv, tframes.read_frames_csv_plain):
        try:
            got = read(path, width, height, n_frames, start=start)
            assert got.dtype == np.uint16
            out.append(("ok", got.shape, got.tolist()))
        except ValueError as err:
            out.append(("error", str(err)))
    return out


def test_reader_round_trip_start_and_no_frames(tmp_path):
    frames = tframes.synthetic_frames(4, 40, 12, seed=3)
    path = tmp_path / "f.csv"
    tframes.write_frames_csv_plain(path, frames)
    for n, start in ((4, 0), (2, 1), (1, 3), (0, 0), (0, 7)):
        got = tframes.read_frames_csv(path, 40, 12, n, start=start)
        np.testing.assert_array_equal(got, frames[start:start + n])
        assert got.shape == (n, 12, 40) and got.dtype == np.uint16
        c, plain = _read_both(path, 40, 12, n, start)
        assert c == plain


MALFORMED = {
    "short row": lambda rows: [rows[0].rsplit(",", 1)[0], *rows[1:]],
    "long row": lambda rows: [rows[0] + ",7", *rows[1:]],
    "too few rows": lambda rows: rows[:-1],
    "sample above 65535": lambda rows: ["65536" + rows[0][1:], *rows[1:]],
    "negative sample": lambda rows: [rows[0], "-" + rows[1], *rows[2:]],
    "stray non-digit": lambda rows: [rows[0].replace(",", ",x", 1),
                                     *rows[1:]],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_reader_raises_the_plain_readers_error(tmp_path, case):
    frames = tframes.synthetic_frames(2, 6, 3, seed=5)
    rows = [",".join(map(str, r)) for r in frames.reshape(-1, 6)]
    path = tmp_path / "bad.csv"
    path.write_text("\n".join(MALFORMED[case](rows)) + "\n")
    c, plain = _read_both(path, 6, 3, 2)
    assert c == plain and c[0] == "error"
    c, plain = _read_both(path, 6, 3, 1, start=1)
    assert c == plain


TOKENS = ["1", "7", "0", "65535", "65536", "99999999999999999999", ",", ",",
          ",", "\n", "\n", "\r", " ", "\t", "-", "+", "x", "."]


def test_reader_parses_as_the_plain_reader(tmp_path):
    """300 texts drawn from a seed: both readers give the same samples or
    the same error (spaces and signs around numbers, empty and unmatched
    fields, rows ending in \r, a last row without a newline)."""
    rng = random.Random(6)
    path = tmp_path / "any.csv"
    for _ in range(300):
        text = "".join(rng.choice(TOKENS) for _ in range(rng.randint(0, 24)))
        path.write_bytes(text.encode())
        args = (rng.randint(1, 3), rng.randint(1, 2), rng.randint(0, 2),
                rng.randint(0, 2))
        c, plain = _read_both(path, *args)
        assert c == plain, (text, args)


def test_frame_writer_gives_savetxts_bytes(tmp_path):
    rng = np.random.default_rng(4)
    cases = [tframes.synthetic_frames(3, 20, 8, seed=1),
             rng.integers(-70000, 70000, (2, 5, 9)).astype(np.int32),
             np.zeros((0, 8, 20), np.uint16)]
    for i, frames in enumerate(cases):
        c, plain = tmp_path / f"c{i}.csv", tmp_path / f"p{i}.csv"
        tframes.write_frames_csv(c, frames)
        tframes.write_frames_csv_plain(plain, frames)
        assert c.read_bytes() == plain.read_bytes(), i


# 130x60: two CTUs, the second one partial in both dimensions
WIDTH, N_CTU = 130, 2


def _costs(seed):
    """Three [N_CTU, PER_CTU] cost slabs with zeros and the largest int32
    among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.integers(0, 2 ** 31 - 1, (N_CTU, PER_CTU))
        a[0, :50] = 0
        a[1, -50:] = 2 ** 31 - 1
        out.append(a)
    return out


DECISION_VARIANTS = {
    "msh": {},
    "full": {"sad": 1, "satd": 2},
    "poc": {"sad": 1, "satd": 2, "poc": 12},
    "sad_only": {"sad": 1},
    "satd_only": {"satd": 2, "poc": 0},
}


@pytest.mark.parametrize("variant", [*DECISION_VARIANTS, "target_ctu"])
def test_decisions_writer_bytes(tmp_path, variant):
    costs = _costs(len(variant))
    paths = [tmp_path / f"{k}.csv" for k in ("c", "numpy", "jax")]
    if variant == "target_ctu":
        kwargs = {"sad_per_frame": [costs[1][0], None],
                  "satd_per_frame": [costs[2][0], costs[2][1]],
                  "pocs": [4, 9]}
        for path, write in zip(paths, (
                texport.export_target_ctu_csv,
                texport.export_target_ctu_csv_plain,
                jexport.export_target_ctu_csv)):
            write(path, [costs[0][0], costs[0][1]], WIDTH, 1, **kwargs)
    else:
        kwargs = {k: (v if k == "poc" else costs[v])
                  for k, v in DECISION_VARIANTS[variant].items()}
        for path, write in zip(paths, (
                texport.export_decisions_csv,
                texport.export_decisions_csv_plain,
                jexport.export_decisions_csv)):
            write(path, costs[0], WIDTH, **kwargs)
    c = paths[0].read_bytes()
    assert c == paths[1].read_bytes()
    assert c == paths[2].read_bytes()
    assert b"2147483647\n" in c and b",0\n" in c


def test_decisions_writer_checks_its_inputs(tmp_path):
    msh = np.zeros((2, PER_CTU), np.int64)
    with pytest.raises(ValueError, match="expected"):
        texport.export_decisions_csv(tmp_path / "x.csv", msh, 256,
                                     sad=msh[:1])
    with pytest.raises(ValueError, match="below 10"):
        texport.export_decisions_csv(tmp_path / "x.csv", msh, 10 ** 6)
    with pytest.raises(FileNotFoundError):
        texport.export_decisions_csv(tmp_path / "no" / "x.csv", msh, 256)
    with pytest.raises(FileNotFoundError):
        tframes.read_frames_csv(tmp_path / "none.csv", 4, 4, 1)


@pytest.fixture
def own_build(monkeypatch, tmp_path):
    """A build directory and csrc of this test's own, with the library
    caches cleared before and after."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "io_native.c").write_bytes(_build.source("io_native")
                                       .read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    native._lib.cache_clear()
    yield csrc
    _build.load_library.cache_clear()
    native._lib.cache_clear()


def test_library_name_follows_source_and_flags(own_build, monkeypatch):
    name = _build.library_path("io_native").name
    assert name.startswith("io_native_") and name.endswith(".so")
    (own_build / "other.cuh").write_text("#pragma once\n")
    assert _build.library_path("io_native").name == name
    src = own_build / "io_native.c"
    src.write_text(src.read_text() + "/* edited */\n")
    edited = _build.library_path("io_native").name
    assert edited != name
    monkeypatch.setattr(_build, "CC_FLAGS", _build.CC_FLAGS + ("-g",))
    assert _build.library_path("io_native").name != edited
    assert "-ffast-math" not in " ".join(_build.CC_FLAGS)


def test_no_compiler_raises_and_never_uses_numpy(own_build, monkeypatch,
                                                 tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    frames = np.zeros((1, 4, 4), np.uint16)
    with pytest.raises(RuntimeError, match="no C compiler"):
        tframes.write_frames_csv(tmp_path / "f.csv", frames)
    tframes.write_frames_csv_plain(tmp_path / "f.csv", frames)
    with pytest.raises(RuntimeError, match="no C compiler"):
        tframes.read_frames_csv(tmp_path / "f.csv", 4, 4, 1)
    with pytest.raises(RuntimeError, match="no C compiler"):
        texport.export_decisions_csv(tmp_path / "d.csv",
                                     np.zeros((1, PER_CTU)), 128)
    assert not (tmp_path / "d.csv").exists()


def test_failed_build_raises_with_the_compilers_output(own_build):
    (own_build / "io_native.c").write_text("int broken(\n")
    with pytest.raises(RuntimeError, match="building io_native failed"):
        _build.load_library("io_native")


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes (as two xdist workers) build the same library into
    an empty build directory at once: each loads a whole library, and one
    library file is left."""
    code = ("import sys; from pathlib import Path; "
            "from vvc_mip_gpu_tpu_torch.ops import _build; "
            "_build.BUILD_DIR = Path(sys.argv[1]); "
            "lib = _build.load_library('io_native'); "
            "print(lib.io_write_samples_csv is not None)")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")], cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == ["True\n", "True\n"]
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]
    assert os.path.getsize(next((tmp_path / "build").iterdir())) > 0
