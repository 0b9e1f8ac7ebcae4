"""List the loops of a built kernel with their instruction counts.

    python3 tools/sass_loops.py frontend [filter]

Builds ``canny_edge_tpu_torch/kernels/csrc/<name>.cu`` as the package does, disassembles the library
with ``cuobjdump -sass`` and prints, for every kernel whose mangled name
contains ``filter``, its length, its barriers and every loop (a backward
branch) with the number of instructions in its body and their mix by
opcode.  With no profiler on the machine this is how a kernel bound by
instruction dispatch is read: instructions per loop trip over the outputs of a
trip give instructions per pixel or per word.  Needs the CUDA toolkit.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(
    r"(?:@!?U?P\d+\s+)?BRA(?:\.\w+)*\s+(?:\w+,\s*)?(0x[0-9a-f]+)")


def _opcode(text: str) -> str:
    parts = text.split()
    op = parts[1] if parts[0].startswith("@") and len(parts) > 1 else parts[0]
    return op.split(".")[0]


def disassemble(name: str) -> str:
    """Build ``csrc/<name>.cu`` and return ``cuobjdump -sass`` of it."""
    from canny_edge_tpu_torch.kernels import _build

    _build.build_all((name,))
    dump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([dump, "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def kernels(sass: str):
    """``{mangled name: [(address, text), ...]}`` of a ``-sass`` listing."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        fn, _, body = chunk.partition("\n")
        out[fn.strip()] = [(int(m.group(1), 16), m.group(2).strip())
                           for m in _INSTR.finditer(body)]
    return out


def loops(instrs):
    """``[(start, end, count, opcode Counter)]`` of the backward branches."""
    found = []
    for addr, text in instrs:
        m = _BRANCH.match(text)
        if m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            body = [t for a, t in instrs if start <= a <= addr]
            found.append((start, addr, len(body),
                          collections.Counter(_opcode(t) for t in body)))
    return found


def main(argv):
    name = argv[1] if len(argv) > 1 else "frontend"
    pick = argv[2] if len(argv) > 2 else ""
    for fn, instrs in kernels(disassemble(name)).items():
        if pick not in fn:
            continue
        bars = sum(t.startswith("BAR") for _, t in instrs)
        print(f"{fn}: {len(instrs)} instructions, {bars} barriers")
        for start, end, count, mix in loops(instrs):
            top = ", ".join(f"{op} {n}" for op, n in mix.most_common(8))
            print(f"  loop {start:#06x}-{end:#06x}: {count} instructions "
                  f"({top})")


if __name__ == "__main__":
    main(sys.argv)
