"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Sets up (frames from the seed, the program's libraries, a
warm-up of the cell's own shapes), measures for ``--seconds``, judges the
outputs against the plain reference, and prints one JSON object as the
last line of standard output: the end-to-end metrics with ``--trace 0``,
the per-layer metrics and the device's busy time with ``--trace 1``.  The
numbers compared, each with its limit, are also the last lines of
standard error.  Without the cards it asks for it exits 2 and prints no
result; with JAX or the JAX package loaded it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "vvc_mip_gpu_tpu"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="portbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cell = harness.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         [torch.device("cuda", i) for i in range(cell.chips)],
                         T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 3
    result["card"] = card_label()
    checks = result.pop("checks")
    result["checks"] = checks  # the last key of the line
    for name, c in checks.items():
        print(f"check {name}: {c['value']} ({c['rule']} {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
