"""Where one call of the K4 kernel (banded hysteresis) spends its time.

    python3 tools/k4_phases.py

The card has no profiler that looks inside a kernel, so this tool builds a
copy of ``canny_edge_tpu_torch/kernels/csrc/hysteresis_banded.cu`` with
time stamps (``clock64`` and ``%globaltimer``, taken by thread 0 of block 0,
which holds band 0) after every phase of the first sweep: pack, the band's
load, the forward and backward pass and the pending test of round 1, the
store, the grid syncs, the needs_more test and the unpack.  It runs the
copy on the headline frame's NMS map at 1080p and 4K (sigma 1.4, 30/90,
band_h 64) and prints cycles and nanoseconds per phase.  The copy goes to
the package's build directory; the package's own library is not touched.
Needs the CUDA toolkit and a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAMP = '''__device__ long long g_prof[32];
__device__ __forceinline__ void stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_prof[i] = clock64();
    g_prof[16 + i] = (long long)t;
  }
}
'''
# (text that occurs once in the source, what it becomes)
PATCHES = [
    ("struct Args {", STAMP + "struct Args {"),
    ("  if (gtid == 0) a.stats[1] =", "  stamp(0);\n  if (gtid == 0) a.stats[1] ="),
    ("           nthreads);\n  grid.sync();\n  int s = 0;",
     "           nthreads);\n  stamp(1);\n  grid.sync();\n  stamp(2);\n  int s = 0;"),
    ("    sweep(ein, eout);\n    grid.sync();\n",
     "    sweep(ein, eout);\n    if (s == 0) stamp(9);\n    grid.sync();\n"
     "    if (s == 0) stamp(10);\n"),
    ("tok, gtid, nthreads);\n    grid.sync();\n",
     "tok, gtid, nthreads);\n    if (s == 0) stamp(11);\n    grid.sync();\n"
     "    if (s == 0) stamp(12);\n"),
    ("a.out, gtid,\n               nthreads);\n}",
     "a.out, gtid,\n               nthreads);\n  stamp(13);\n}"),
    ("      __syncthreads();\n      const int mine = base",
     "      __syncthreads();\n      stamp(3);\n      const int mine = base"),
    ("      pass(std::true_type{}, true);\n      pass(std::true_type{}, false);\n",
     "      pass(std::true_type{}, true);\n      stamp(4);\n"
     "      pass(std::true_type{}, false);\n      stamp(5);\n"),
    ("    if (!pending()) break;\n",
     "    const bool pend = pending();\n    if (rounds == 1) stamp(6);\n"
     "    if (!pend) break;\n"),
    ("        if (lane == 0) count_rounds(a.stats, rounds);\n      }\n"
     "      __syncthreads();\n",
     "        if (lane == 0) count_rounds(a.stats, rounds);\n      }\n"
     "      stamp(7);\n      __syncthreads();\n      stamp(8);\n"),
    ('extern "C" {\n',
     'extern "C" {\nint canny_banded_stamps(long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 32);\n}\n"),
]
PHASES = ["start", "pack", "grid sync", "band load", "forward pass",
          "backward pass", "pending test", "later rounds", "block barrier",
          "store", "grid sync", "needs_more", "grid sync", "unpack"]


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

    src = (_build.CSRC / "hysteresis_banded.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"the source moved: {old!r} occurs "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "hysteresis_banded_stamped.cu"
    so = _build.BUILD_DIR / "libhysteresis_banded_stamped.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.canny_banded.argtypes = _build.SIGNATURES["hysteresis_banded"][
        "canny_banded"]
    lib.canny_banded_stamps.argtypes = [ctypes.c_void_p]

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda:0")
    taps = torch.from_numpy(gaussian_kernel(cs.SIGMA)).to(dev)
    for name, (h, w) in cs.SIZES.items():
        nm = kfe.frontend(torch.from_numpy(cs.make_image(h, w)).to(dev), taps)
        wd = -(-w // 32)
        weak, e0, e1 = (torch.empty((h, wd), dtype=torch.int32, device=dev)
                        for _ in range(3))
        out = torch.empty((h, w), dtype=torch.int16, device=dev)
        ctl = torch.zeros(4, dtype=torch.int64, device=dev)
        samples = []
        for it in range(9):
            err = lib.canny_banded(
                nm.data_ptr(), 2, cs.MN, cs.MX, weak.data_ptr(), e0.data_ptr(),
                e1.data_ptr(), out.data_ptr(), 1, h, w, 64, ctl.data_ptr(),
                (it + 1) << 32, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"canny_banded: CUDA error {err}")
            torch.cuda.synchronize()
            stamps = (ctypes.c_longlong * 32)()
            lib.canny_banded_stamps(stamps)
            samples.append(list(stamps))
        med = np.median(np.diff(np.array(samples), axis=1), axis=0)
        sweeps, rounds_max = ctl[2:].view(torch.int32).tolist()[:2]
        print(f"{name}: {sweeps} sweep(s), at most {rounds_max} round(s) a "
              f"band; median of 9 calls, block 0")
        for i in range(1, 14):
            print(f"  {PHASES[i]:>14}: {int(med[i - 1]):7d} cycles "
                  f"{int(med[16 + i - 1]):7d} ns")
        total = np.median([s[13] - s[0] for s in samples])
        total_ns = np.median([s[29] - s[16] for s in samples])
        print(f"  {'in the kernel':>14}: {int(total):7d} cycles "
              f"{int(total_ns):7d} ns")


if __name__ == "__main__":
    main()
