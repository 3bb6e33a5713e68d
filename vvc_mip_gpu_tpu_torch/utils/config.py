"""Runtime configuration.

Collapses the reference's two config tiers — boost::program_options runtime
flags (reference: main.cpp:50-83) and compile-time behavior macros
(main.cpp:3-12, main_aux_functions.h:1-7) — into one dataclass.  Mapping:

| reference                       | here                                |
|---------------------------------|-------------------------------------|
| -f / FramesToBeEncoded          | n_frames                            |
| -s / Resolution ("1920x1080")   | width, height                       |
| -o / OriginalFrames             | input_path                          |
| -l / OutputPreffix              | output_prefix                       |
| --FilterType / --KernelIdx      | filter_type, kernel_idx             |
| --DeviceIndex                   | device_index (the CUDA device)      |
| USE_ALTERNATIVE_SAMPLES macro   | filter_type is not None             |
| ONLY_FILTER_AND_EXIT macro      | only_filter                         |
| MAX_PERFORMANCE_DIST macro      | max_performance (export minSadHad   |
|                                 |  only; SAD/SATD columns zeroed)     |
| TRACE_POWER macro               | trace_power (stage stdout markers)  |
| BUFFER_SLOTS prefetch           | batch_frames (device batching)      |
| USE_ARM macro                   | n/a (no per-vendor kernel variants) |

The multi-device fields (mesh_data, mesh_space, latency_mode, coordinator,
num_processes, process_id) are parsed for command-line compatibility with
the JAX package's CLI; the port runs one device until its ``parallel``
package exists, and ``validate`` rejects them.
"""

from __future__ import annotations

import dataclasses

from vvc_mip_gpu_tpu_torch.constants import AVAILABLE_FILTERS, AVAILABLE_RES

_NO_PARALLEL = ("is not ported yet (the multi-device engines, ROADMAP "
                "A.8); this port runs on one device")


@dataclasses.dataclass
class EngineConfig:
    width: int = 1920
    height: int = 1080
    n_frames: int = 1
    input_path: str | None = None
    output_prefix: str = ""
    filter_type: str | None = None
    kernel_idx: int = 0
    only_filter: bool = False
    max_performance: bool = True
    trace_power: bool = False
    batch_frames: int = 8  # frames per device dispatch (pipelining window)
    device_index: int = 0
    mesh_data: int = 1
    mesh_space: int = 1
    latency_mode: bool = False
    coordinator: str | None = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def parse_resolution(cls, text: str) -> tuple[int, int]:
        try:
            w, h = text.lower().split("x")
            return int(w), int(h)
        except ValueError as e:
            raise ValueError(f"bad resolution {text!r}; expected WxH") from e

    def validate(self) -> None:
        if self.filter_type is not None:
            if self.filter_type not in AVAILABLE_FILTERS:
                raise ValueError(
                    f"filter type {self.filter_type!r} not supported; "
                    f"available: {list(AVAILABLE_FILTERS)}")
            n_kernels = 3 if "5x5" in self.filter_type else 5
            if not 0 <= self.kernel_idx < n_kernels:
                raise ValueError(f"KernelIdx {self.kernel_idx} out of range")
        if (self.width, self.height) not in AVAILABLE_RES:
            # Unlike the reference, any multiple-of-4 size is accepted.
            if self.width % 4 or self.height % 4:
                raise ValueError("frame dimensions must be multiples of 4")
        if self.n_frames < 1:
            raise ValueError("n_frames must be >= 1")
        if self.mesh_data * self.mesh_space > 1:
            raise ValueError(f"--MeshData/--MeshSpace > 1 {_NO_PARALLEL}")
        if self.latency_mode:
            raise ValueError(f"--LatencyMode {_NO_PARALLEL}")
        if (self.coordinator is not None or self.num_processes > 1
                or self.process_id != 0):
            raise ValueError(f"--Coordinator/--NumProcesses > 1/--ProcessId "
                             f"{_NO_PARALLEL}")
