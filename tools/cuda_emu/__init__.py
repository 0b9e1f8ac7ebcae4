"""Run a CUDA source of the port on the CPU, to test the kernel's logic.

    from tools.cuda_emu import build
    lib = build("frontend", out_dir)    # ctypes library of its C entries

This builds ``canny_edge_tpu_torch/kernels/csrc/<name>.cu`` with g++
against ``tools/cuda_emu/emu.h``, an emulation of the CUDA subset the
kernels use: every thread of a block is a fiber (``ucontext``);
``__syncthreads``, named barriers (``bar.sync`` / ``bar.arrive``) and
``__ballot_sync`` are barriers among the fibers; dynamic shared memory is
one buffer, filled with garbage before each block; a launch runs its blocks
one after another; ``cp.async`` copies at once.  Floating point is the
host's IEEE single precision, each operation rounded on its own, so
``__fmul_rn``, ``__fadd_rn`` and ``__fdiv_rn`` round as on the card; the
approximate square root of ``mag_dir`` becomes ``std::sqrt`` (the kernel
steps it to the exact integer root either way).  Warp shuffles and votes
other than the ballot are declared, not emulated: a kernel that calls them
does not link.

The result shows that a kernel's indexing, barriers and arithmetic give the
plain version's bits on the inputs it is run on; not that nvcc accepts the
source, and nothing about its speed.  ``emu_sms``, ``emu_per_sm`` and
``emu_optin`` (C ints of the library) are the SMs, blocks an SM and opt-in
shared memory the emulated card reports; ``emu_grid`` (3 C unsigned ints)
is the grid of the last launch.  Needs g++.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).parent
CSRC = HERE.parent.parent / "canny_edge_tpu_torch" / "kernels" / "csrc"

# (pattern, replacement) applied to the source, in order
REWRITES = [
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch(grid, block,
    # smem, stream, a lambda that calls kernel, args): the call resolves a
    # kernel name that names overloads
    (r"([\w:]+(?:<\w+>)?)\s*<<<(.*?)>>>\(",
     r"emu_launch(\2, [&](auto... a) { \1(a...); }, "),
    (r'asm\("sqrt\.approx\.f32.*?\)\);', "k = std::sqrt(n);"),
    (r'asm volatile\("bar\.sync %0, %1;".*?\);', "emu_bar_sync(id, n);"),
    (r'asm volatile\("bar\.arrive %0, %1;".*?\);', "emu_bar_arrive(id, n);"),
    (r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emu_smem;"),
]
DECLARED = """
unsigned __brev(unsigned);
unsigned __shfl_sync(unsigned, unsigned, int);
unsigned __shfl_up_sync(unsigned, unsigned, int);
unsigned __shfl_down_sync(unsigned, unsigned, int);
bool __any_sync(unsigned, bool);
"""


def build(name: str, out_dir) -> ctypes.CDLL:
    """The CPU build of ``csrc/<name>.cu`` in ``out_dir``, loaded, with the
    argument types of ``kernels/_build.py:SIGNATURES[name]``."""
    from canny_edge_tpu_torch.kernels._build import SIGNATURES

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("cuda_emu needs g++")
    out = Path(out_dir)
    inc = out / "inc"
    inc.mkdir(parents=True, exist_ok=True)
    for header in ("cuda_pipeline.h", "cuda_runtime.h"):
        (inc / header).write_text('#include "emu.h"\n' + DECLARED)
    for cuh in CSRC.glob("*.cuh"):
        shutil.copy(cuh, inc / cuh.name)
    src = (CSRC / f"{name}.cu").read_text()
    for pattern, repl in REWRITES:
        src = re.sub(pattern, repl, src, flags=re.S)
    cpp = out / f"{name}_emu.cpp"
    cpp.write_text(src)
    lib = out / f"lib{name}_emu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-ffp-contract=off", "-Wno-unknown-pragmas",
                    f"-I{HERE}", f"-I{inc}", "-include", "emu.h", str(cpp),
                    str(HERE / "emu.cpp"), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for entry, args in SIGNATURES[name].items():
        getattr(dll, entry).argtypes = args
        getattr(dll, entry).restype = ctypes.c_int
    return dll
