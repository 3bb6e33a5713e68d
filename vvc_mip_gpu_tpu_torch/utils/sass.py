"""Static SASS instruction mix of the kernels in a built library.

``cuobjdump -sass`` (part of the CUDA toolkit) disassembles the library;
each kernel's instructions are counted by opcode, the mnemonic before its
first ".".  Counts are static: an instruction inside a loop counts once.

    python -m vvc_mip_gpu_tpu_torch.utils.sass LIBRARY [KERNEL ...]

prints one line per kernel (all, or those whose name contains one of the
KERNEL strings) with the counts of ``OPCODES`` and the total.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

# loads and stores by memory space, shuffles and barriers, then the integer
# arithmetic the cost kernels are made of
OPCODES = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "ULDC", "SHFL",
           "BAR", "IMAD", "IADD3", "LOP3", "SHF", "IABS", "IMNMX", "VIMNMX",
           "ISETP", "SEL", "LEA", "PRMT")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
_MANGLED = re.compile(r"\d(mip_\w+?_kernel)I((?:Li\d+E)+)")


def kernel_name(mangled: str) -> str:
    """``mip_cost_sid0_kernel<4,4>`` from its mangled name (unchanged if
    it is not a template of this package)."""
    m = _MANGLED.search(mangled)
    if not m:
        return mangled
    return f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"


def instruction_mix(library: Path) -> dict[str, collections.Counter]:
    """{kernel name: Counter(opcode -> static count)} of one library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found: it ships with the CUDA "
                           "toolkit")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    mix: dict[str, collections.Counter] = {}
    current = None
    for line in text.splitlines():
        if m := _FUNCTION.search(line):
            current = mix.setdefault(kernel_name(m[1]), collections.Counter())
        elif current is not None and (m := _INSTRUCTION.search(line)):
            current[m[1]] += 1
    return mix


def describe(counts: collections.Counter) -> str:
    shown = " ".join(f"{op} {counts[op]}" for op in OPCODES if counts[op])
    return f"{shown}; total {sum(counts.values())}"


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for name, counts in instruction_mix(Path(argv[0])).items():
        if len(argv) == 1 or any(k in name for k in argv[1:]):
            print(f"sass {name}: {describe(counts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
