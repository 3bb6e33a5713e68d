"""Power tracer: run the port's CLI while a power meter is polled.

The counterpart of the JAX package's tools/power_tracer.py and of the
reference's powerTracer_NVIDIA.py, which forks the engine and polls
nvidia-smi (powerTracer_NVIDIA.py:9-25).  It runs ``python -m
vvc_mip_gpu_tpu_torch.cli --TracePower ...`` from the current directory
while a thread runs the meter command again and again: by default
``nvidia-smi --query-gpu=power.draw --format=csv,noheader,nounits``;
``--power-cmd`` takes any shell command that prints watts.  Every line of
the meter's output that holds a number is one sample, timed when it
arrives, so a meter that keeps printing (``nvidia-smi ... -lms 20``) works
too.  Each run writes ``<prefix>power.csv`` (``timestamp_s,power_w``) and
``<prefix>stdout.log`` (the CLI's output with its START/FINISH markers),
which ``compute_energy`` reads.  A run whose meter gave no sample, or
whose CLI failed, raises.

Like the reference, it sweeps the frame count (1..16 at 1080p, 1..4 at
4K; powerTracer_NVIDIA.py:32-80):

    python -m vvc_mip_gpu_tpu_torch.tools.power_tracer -s 1920x1080 \\
        --max-frames 2 --prefix out/power_ [-- --FullDistortion]

Standard library only; it can also be run by its path.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import threading
import time

NVIDIA_SMI = "nvidia-smi --query-gpu=power.draw --format=csv,noheader,nounits"


def _watts(line: str) -> float | None:
    try:
        return float(line.strip().split()[0].rstrip(","))
    except (IndexError, ValueError):
        return None


class PowerMeter:
    """Runs the shell command ``cmd`` again and again on a thread, ``interval_s``
    apart, while inside a ``with`` block, and writes each watt value it
    prints to ``out_path`` with the time it arrived.  Leaving the block
    raises RuntimeError when no sample came."""

    def __init__(self, cmd: str, out_path: str, interval_s: float):
        self.cmd = cmd
        self.out_path = out_path
        self.interval_s = interval_s
        self.samples = 0
        self.failed = 0  # runs that exited non-zero or printed no value
        self.last_failure = "no run ended"
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._proc: subprocess.Popen | None = None
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self) -> None:
        with open(self.out_path, "w") as f:
            f.write("timestamp_s,power_w\n")
            while not self._stop.is_set():
                with self._lock:
                    if self._stop.is_set():
                        break
                    self._proc = subprocess.Popen(
                        self.cmd, shell=True, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True)
                got = 0
                for line in self._proc.stdout:
                    watts = _watts(line)
                    if watts is not None:
                        f.write(f"{time.time():.6f},{watts}\n")
                        got += 1
                err = self._proc.stderr.read()
                rc = self._proc.wait()
                self.samples += got
                if (rc or not got) and not self._stop.is_set():
                    self.failed += 1
                    self.last_failure = (f"exit code {rc}, {got} values, "
                                         f"stderr {err.strip()[-300:]!r}")
                self._stop.wait(self.interval_s)

    def __enter__(self) -> "PowerMeter":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        with self._lock:
            self._stop.set()
            if self._proc is not None and self._proc.poll() is None:
                self._proc.terminate()
        self._thread.join()
        if not self.samples and exc[0] is None:
            raise RuntimeError(
                f"power meter {self.cmd!r} gave no sample in {self.failed} "
                f"polls (last: {self.last_failure})")
        return False


def run_once(engine_args: list[str], power_cmd: str, trace_prefix: str,
             interval_s: float) -> tuple[str, str]:
    """One traced CLI run; returns (stdout log, power CSV) paths."""
    log_path = f"{trace_prefix}stdout.log"
    power_path = f"{trace_prefix}power.csv"
    with PowerMeter(power_cmd, power_path, interval_s):
        with open(log_path, "w") as log:
            rc = subprocess.run(
                [sys.executable, "-m", "vvc_mip_gpu_tpu_torch.cli",
                 "--TracePower", *engine_args],
                stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL).returncode
    if rc:
        with open(log_path) as log:
            tail = log.read()[-3000:]
        raise RuntimeError(f"the CLI exited with {rc}:\n{tail}")
    return log_path, power_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--power-cmd", default=NVIDIA_SMI,
                   help="shell command printing instantaneous power (W)")
    p.add_argument("-s", "--resolution", default="1920x1080")
    p.add_argument("--interval-ms", type=float, default=10.0,
                   help="pause between two runs of the meter command")
    p.add_argument("--max-frames", type=int, default=None,
                   help="sweep 1..N frames (default 16 @1080p, 4 @4K)")
    p.add_argument("--prefix", default="power_")
    p.add_argument("engine_args", nargs="*",
                   help="extra arguments of the CLI (after --)")
    args = p.parse_args(argv)
    max_frames = args.max_frames or (4 if "2160" in args.resolution else 16)
    for n in range(1, max_frames + 1):
        prefix = f"{args.prefix}{args.resolution}_f{n}_"
        run_once(["-s", args.resolution, "-f", str(n), "--Synthetic",
                  "-l", prefix, *args.engine_args],
                 args.power_cmd, prefix, args.interval_ms / 1e3)
        print(f"completed nFrames={n}", flush=True)


if __name__ == "__main__":
    main()
