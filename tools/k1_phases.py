"""Where a block of K1's ring path (windows from 105 taps) spends its time.

    python3 tools/k1_phases.py [--windows 105,121,263,601] [--batch B]
                               [--tree DIR]

The card has no profiler that looks inside a kernel, so this tool builds a
copy of ``canny_edge_tpu_torch/kernels/csrc/frontend.cu`` whose ring kernel
(``frontend_ring_kernel``) reads ``clock64`` after each of its phases and
adds the cycles since the last reading to that phase's total, over all of a
block's segments and steps.  The block's two warp groups run different
phases at once: an x-pass warp (thread 0) the set-up, each segment's
prologue (the strip's divisors, the prologue's x-pass rows and, after the
first segment, the wait for the y-pass to release the ring), then in each
32-row step fetching the next input rows into registers, the x-pass, the
group's barrier, storing the fetched rows, the wait for the y-pass to
release the ring rows it overwrites, writing them, and the barrier; a
y-pass warp (thread 256) the set-up, each segment's row divisors and the
wait for its prologue's rows, its 4 blurred rows, then in each step the
wait for the step's rows, the y-pass, the group's barrier, the back half
and the barrier with the copy of 4 blurred rows.  Both threads are of
block (1, 1, 0) of a grid of equal runs, block 1 of a grid of spans
across strips and frames (a block of several segments where the launch
has them).  A wait or a barrier is what a warp waits for the others.  Runs
the copy in threshold mode on a batch of ``B`` 1080p frames
(``tools/k1_sweep.py``'s) and prints the launch's blocks, segments and
longest block, the stamped block's segments and steps, cycles per phase,
the prologue's share of the x-pass warp's cycles, a prologue row's cycles
against a step row's (the weight ``w`` of
``csrc/frontend.cu:ring_launch_of``), the kernel's device time (CUDA
events, median of 5 calls) and the card's name and power limit.
``--tree`` stamps another tree's source of the same kernel.  The copy goes
to the package's build directory; the package's own library is not
touched.  Needs the CUDA toolkit and a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (the x-pass warps' phase, the y-pass warps' phase) of each lap
PHASES = [("set-up", "set-up"), ("prologue", "wait for the prologue"),
          ("fetch", "prologue y-pass"), ("x-pass", "wait for the rows"),
          ("barrier", "y-pass"), ("store", "barrier"),
          ("wait for the y-pass", "back half"), ("write", "barrier + copy"),
          ("barrier", "")]
STAMP = '''__device__ long long g_k1_prof[2][16];
'''
# (text that occurs once in the source, what it becomes)
PATCHES = [
    ("struct RingGeo {", STAMP + "struct RingGeo {"),
    ("  const int P = 4 + 2 * c;             // x-pass rows of blurred rows 0..3\n",
     "  const int P = 4 + 2 * c;             // x-pass rows of blurred rows 0..3\n"
     "  long long lap_t = clock64(), lap_acc[9] = {0};\n"
     "  auto lap = [&](int i) {\n"
     "    const long long t = clock64();\n"
     "    lap_acc[i] += t - lap_t;\n"
     "    lap_t = t;\n"
     "  };\n"),
    ("  };\n\n  if (xw) {\n",
     "  };\n  lap(0);\n\n  if (xw) {\n"),
    ("      bar_arrive(BAR_FULL, RT);        // the prologue's rows are written\n",
     "      lap(1);\n"
     "      bar_arrive(BAR_FULL, RT);        // the prologue's rows are written\n"),
    ("        fetch(rows, j1, n1, next);\n        xcompute(RTH, acc);\n"
     "        bar_sync(BAR_X, RG);\n        store(rows, j1, n1, next);\n"
     "        bar_sync(BAR_EMPTY, RT);       // the rows these overwrite are read\n"
     "        xwrite(P + RTH * k, RTH, acc);\n"
     "        bar_arrive(BAR_FULL, RT);      // step k's rows are written\n"
     "        bar_sync(BAR_X, RG);\n",
     "        fetch(rows, j1, n1, next);\n        lap(2);\n"
     "        xcompute(RTH, acc);\n        lap(3);\n"
     "        bar_sync(BAR_X, RG);\n        lap(4);\n"
     "        store(rows, j1, n1, next);\n        lap(5);\n"
     "        bar_sync(BAR_EMPTY, RT);\n        lap(6);\n"
     "        xwrite(P + RTH * k, RTH, acc);\n"
     "        bar_arrive(BAR_FULL, RT);\n        lap(7);\n"
     "        bar_sync(BAR_X, RG);\n        lap(8);\n"),
    ("      bar_sync(BAR_FULL, RT);          // the prologue's rows are written\n",
     "      bar_sync(BAR_FULL, RT);          // the prologue's rows are written\n"
     "      lap(1);\n"),
    ("      bar_arrive(BAR_EMPTY, RT);       // x-pass rows 0..3 are read\n",
     "      lap(2);\n"
     "      bar_arrive(BAR_EMPTY, RT);       // x-pass rows 0..3 are read\n"),
    ("        bar_sync(BAR_FULL, RT);        // step k's rows are written\n",
     "        bar_sync(BAR_FULL, RT);        // step k's rows are written\n"
     "        lap(3);\n"),
    ("        if (k + 1 < sg.steps || sg.rest > 0) bar_arrive(BAR_EMPTY, RT);\n",
     "        if (k + 1 < sg.steps || sg.rest > 0) bar_arrive(BAR_EMPTY, RT);\n"
     "        lap(4);\n"),
    ("        bar_sync(BAR_Y, RG);\n        back_half<RTH, BAR_Y>",
     "        bar_sync(BAR_Y, RG);\n        lap(5);\n        back_half<RTH, BAR_Y>"),
    ("                              gt, packed, mn, mx, nm_out, weak, strong);\n"
     "        bar_sync(BAR_Y, RG);\n",
     "                              gt, packed, mn, mx, nm_out, weak, strong);\n"
     "        lap(6);\n        bar_sync(BAR_Y, RG);\n"),
    ("        for (int i = gt; i < 4 * XW; i += RG) sm[i] = sm[RTH * XW + i];\n"
     "      }\n      if (sg.rest == 0) break;\n    }\n  }\n}\n",
     "        for (int i = gt; i < 4 * XW; i += RG) sm[i] = sm[RTH * XW + i];\n"
     "        lap(7);\n      }\n      if (sg.rest == 0) break;\n    }\n  }\n"
     "  if (blockIdx.x == 1 && blockIdx.y == (gridDim.y > 1)\n"
     "      && blockIdx.z == 0\n"
     "      && (tid == 0 || tid == RG)) {\n"
     "    long long b, e;\n"
     "    span_of(sp, f.B, blockIdx.x, blockIdx.y, blockIdx.z, &b, &e);\n"
     "    for (int i = 0; i < 9; ++i) g_k1_prof[tid / RG][i] = lap_acc[i];\n"
     "    g_k1_prof[tid / RG][9] = e - b;\n"
     "    g_k1_prof[tid / RG][10] = segments_of(sp, b, e);\n"
     "  }\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\nint canny_frontend_stamps(long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, g_k1_prof,\n"
     "                                   sizeof(long long) * 32);\n}\n"),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", default="105,121,263,601")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()

    import numpy as np
    import torch

    from bench_torch import make_image
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from tools.k1_sweep import MN, MX, sweep_frame

    csrc = os.path.join(os.path.abspath(args.tree), "canny_edge_tpu_torch",
                        "kernels", "csrc")
    src = open(os.path.join(csrc, "frontend.cu")).read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"the source moved: {old!r} occurs "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "frontend_stamped.cu"
    so = _build.BUILD_DIR / "libfrontend_stamped.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc,
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for entry in ("canny_frontend", "canny_frontend_ring_geometry"):
        getattr(lib, entry).argtypes = _build.SIGNATURES["frontend"][entry]
    lib.canny_frontend_stamps.argtypes = [ctypes.c_void_p]

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda:0")
    h, w, b = 1080, 1920, args.batch
    img = torch.from_numpy(sweep_frame(h, w, make_image)).to(dev).expand(
        b, h, w).contiguous()
    wd = -(-w // 32)
    weak = torch.empty((b, h, wd), dtype=torch.int32, device=dev)
    strong = torch.empty_like(weak)
    stream = torch.cuda.current_stream().cuda_stream
    for win in map(int, args.windows.split(",")):
        taps = torch.from_numpy(gaussian_kernel((win // 2 - 0.5) / 3)).to(dev)

        def call():
            err = lib.canny_frontend(img.data_ptr(), 1, b, h, w,
                                     taps.data_ptr(), win, 1, MN, MX, None,
                                     weak.data_ptr(), strong.data_ptr(),
                                     stream)
            if err:
                raise SystemExit(f"canny_frontend: CUDA error {err}")

        samples, ms = [], []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            stamps = (ctypes.c_longlong * 32)()
            lib.canny_frontend_stamps(stamps)
            samples.append(list(stamps))
        med = np.median(np.array(samples), axis=0)
        geo = (ctypes.c_longlong * 7)()
        lib.canny_frontend_ring_geometry(b, h, w, win, geo, 1)
        print(f"window {win}, {b} frames: {float(np.median(ms)):.4f} ms a "
              f"call (events, median of 5); {geo[4]} blocks on {geo[0]} "
              f"slots, {geo[2]} segments ({geo[2] / geo[4]:.3f} a block), "
              f"the longest block {geo[3]} steps; the stamped block: "
              f"{int(med[10])} segments, {int(med[9])} steps; cycles per "
              f"phase of an x-pass warp (thread 0) | a y-pass warp "
              f"(thread 256)")
        for i, (xname, yname) in enumerate(PHASES):
            print(f"  {xname:>20}: {int(med[i]):9d} | {yname:>22}: "
                  f"{int(med[16 + i]):9d}")
        print(f"  {'in the kernel':>20}: {int(sum(med[:9])):9d} | "
              f"{'':>22}  {int(sum(med[16:25])):9d}")
        # a prologue row (4 + 2c of them a segment) against a step row (32
        # a step)
        pro = med[1] / (med[10] * (4 + win // 2 * 2))
        step = sum(med[2:9]) / (32 * med[9])
        print(f"  prologue {med[1] / sum(med[:9]):.1%} of the x-pass warp's "
              f"cycles; set-up {med[0] / sum(med[:9]):.1%}; a prologue row "
              f"{pro:.0f} cycles, a step row {step:.0f}: w = {pro / step:.3f}")


if __name__ == "__main__":
    main()
