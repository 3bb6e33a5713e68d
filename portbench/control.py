"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in int16, the nearest
precision below the int32 the configurations state (the step a kernel
would take to pack two 16-bit results into each 32-bit lane).  It has to
come out as not correct.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

For each seed it makes the cell's frames, picks the CTUs a run judges
(of as many steps as a run keeps), computes their costs with the
reference in int16 and in int64, and compares them as a run does.
Prints one JSON line per seed.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench import harness, judge


def control_reading(cell: harness.Cell, seed: int, device) -> dict:
    """The comparison's numbers with the reference in int16 in the
    program's place, on the CTUs a run of ``cell`` with ``seed`` judges."""
    loop = harness.loop_class(cell.traffic["entry"], cell.root)(
        cell.config, cell.traffic, seed, [device], None)
    pool = loop.make_pool()
    kept = cell.traffic["keep_last"] + bool(cell.traffic.get(
        "keep_early_below"))  # as many steps as a run keeps
    steps = [judge.Kept(loop.batch_frames(i), {}) for i in range(kept)]
    picks = judge.select(steps, loop.width, loop.height,
                         cell.traffic["judge_ctus_per_frame"], seed)
    t = time.perf_counter()
    reference, valid = judge.reference_rows(pool, picks, loop.filter,
                                            loop.fields, device)
    t_ref = time.perf_counter() - t
    program, _ = judge.reference_rows(pool, picks, loop.filter, loop.fields,
                                      device, dtype=torch.int16)
    out = judge.compare({f: v.to(torch.int64) for f, v in program.items()},
                        reference, valid, picks)
    out["reference_s"] = t_ref
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.control: no CUDA card")
    for seed in (int(s) for s in args.seeds.split(",")):
        reading = control_reading(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, **reading}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
