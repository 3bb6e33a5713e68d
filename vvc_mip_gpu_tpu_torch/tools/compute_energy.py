"""Energy analysis: align the CLI's stage markers with a power trace.

The analog of the reference's computeEnergy_{NVIDIA,AMD}.py: parse the
``--TracePower`` stdout markers of ``python -m vvc_mip_gpu_tpu_torch.cli``
("START <stage>,<unix time>" / "FINISH <stage>,<unix time>",
utils/timing.py), align them with the ``timestamp_s,power_w`` CSV that
``power_tracer`` writes, and report average power and energy (average
power x time) over the active window, per stage, and per frame when the
log holds the CLI's compact report ("TotalElapsedMs,...,frames,<n>,...")
(reference: computeEnergy_NVIDIA.py:41-100, 154-167).  Standard library
only, so the tracer-to-energy chain runs wherever the CLI does.

    python -m vvc_mip_gpu_tpu_torch.tools.compute_energy STDOUT_LOG POWER_CSV
"""

from __future__ import annotations

import argparse
import re


def parse_markers(lines) -> dict[str, list[tuple[float, float]]]:
    """{stage: [(start, finish), ...]} from START/FINISH marker pairs."""
    opens: dict[str, float] = {}
    stages: dict[str, list[tuple[float, float]]] = {}
    for line in lines:
        m = re.match(r"(START|FINISH) (.+),([0-9.]+)$", line.strip())
        if not m:
            continue
        kind, stage, ts = m.group(1), m.group(2), float(m.group(3))
        if kind == "START":
            opens[stage] = ts
        elif stage in opens:
            stages.setdefault(stage, []).append((opens.pop(stage), ts))
    return stages


def parse_power(lines) -> list[tuple[float, float]]:
    out = []
    for line in lines:
        parts = line.strip().split(",")
        if len(parts) == 2:
            try:
                out.append((float(parts[0]), float(parts[1])))
            except ValueError:
                continue
    return out


def parse_frames(lines) -> int | None:
    """The frame count of the CLI's compact report, if the log has one."""
    for line in lines:
        m = re.match(r"TotalElapsedMs,[0-9.]+,frames,(\d+),", line.strip())
        if m:
            return int(m.group(1))
    return None


def window_energy(power: list[tuple[float, float]], t0: float,
                  t1: float) -> tuple[float, float]:
    """(avg_power_w, energy_j) over [t0, t1] by sample averaging —
    the reference's method (computeEnergy_NVIDIA.py:154-167)."""
    samples = [p for t, p in power if t0 <= t <= t1]
    if not samples:
        return 0.0, 0.0
    avg = sum(samples) / len(samples)
    return avg, avg * (t1 - t0)


def analyze(marker_lines, power_lines) -> dict:
    """{"stages": {stage: time_s, energy_j, count}} and, when the log has
    markers, the active window's length, average power and energy; with
    the CLI's compact report also "frames" and "energy_per_frame_j"."""
    marker_lines = list(marker_lines)
    stages = parse_markers(marker_lines)
    power = parse_power(power_lines)
    report: dict = {"stages": {}}
    all_times = [t for spans in stages.values() for span in spans
                 for t in span]
    if all_times:
        t0, t1 = min(all_times), max(all_times)
        avg, e = window_energy(power, t0, t1)
        report["active_window_s"] = t1 - t0
        report["avg_power_w"] = avg
        report["energy_j"] = e
        frames = parse_frames(marker_lines)
        if frames:
            report["frames"] = frames
            report["energy_per_frame_j"] = e / frames
    for stage, spans in stages.items():
        total = sum(b - a for a, b in spans)
        energy = sum(window_energy(power, a, b)[1] for a, b in spans)
        report["stages"][stage] = {
            "time_s": total, "energy_j": energy, "count": len(spans)}
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("stdout_log")
    p.add_argument("power_csv")
    args = p.parse_args(argv)
    with open(args.stdout_log) as f:
        markers = f.readlines()
    with open(args.power_csv) as f:
        power = f.readlines()
    report = analyze(markers, power)
    if "avg_power_w" in report:
        print(f"active window: {report['active_window_s']:.3f} s, "
              f"avg power {report['avg_power_w']:.1f} W, "
              f"energy {report['energy_j']:.1f} J")
    if "energy_per_frame_j" in report:
        print(f"energy per frame: {report['energy_per_frame_j']:.2f} J "
              f"({report['frames']} frames)")
    for stage, info in report["stages"].items():
        print(f"  {stage:<24s} {info['time_s'] * 1e3:10.1f} ms  "
              f"{info['energy_j']:8.2f} J  x{info['count']}")


if __name__ == "__main__":
    main()
