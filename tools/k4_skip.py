"""What K4's step-skipping rule gains on inputs that need several rounds.

    python3 tools/k4_skip.py

After a band's first round the K4 kernel (banded hysteresis,
``canny_edge_tpu_torch/kernels/csrc/hysteresis_banded.cu``) runs a row step
only if the neighbour row changed since the step last ran.  This tool builds
a copy of the kernel in which every round runs every step, as round 1 does
(the two ``pass(std::false_type{}, ...)`` calls become ``std::true_type``),
and times the package's kernel and the copy on the same inputs through the
package's wrapper: the headline frame (one round a band: the control),
sparse chains at one, two and four words a lane, and the 1080p serpentine,
at the default band and at 16 rows.  Prints sweeps, rounds a band, and the
wall time of a call (CUDA events, median of 5 samples of 10 calls back to
back) with and without the rule; the outputs must be equal.  The copy goes
to the package's build directory; the package's own library is not touched.
Needs the CUDA toolkit and a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SKIPPING = ("      pass(std::false_type{}, true);\n"
            "      pass(std::false_type{}, false);\n")
EVERY_STEP = SKIPPING.replace("false_type", "true_type")


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
    from canny_edge_tpu_torch.kernels._scratch import Scratch
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

    name = "hysteresis_banded"
    src = (_build.CSRC / f"{name}.cu").read_text()
    if src.count(SKIPPING) != 1:
        raise SystemExit("the source moved: the skipping rounds were not found")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}_every_step.cu"
    so = _build.BUILD_DIR / f"lib{name}_every_step.so"
    cu.write_text(src.replace(SKIPPING, EVERY_STEP))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True)
    every = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(every, fn).argtypes = argtypes
        getattr(every, fn).restype = ctypes.c_int
    libs = {"skip": _build.load(name), "every step": every}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    taps = torch.from_numpy(gaussian_kernel(cs.SIGMA)).to(dev)
    h, w = cs.SIZES["1080p"]
    frame = kfe.frontend(torch.from_numpy(cs.make_image(h, w)).to(dev), taps)
    cases = [("frame 1080p", frame, cs.MN, cs.MX, [None, 16])]
    for shape in ((150, 1000), (150, 1921), (150, 3840), (1080, 1920)):
        cases.append((f"sparse {shape[0]}x{shape[1]}",
                      torch.from_numpy(cs.sparse_nm(rng, *shape)).to(dev),
                      10, 100, [64, 16]))
    cases.append(("serpentine 1080p",
                  torch.from_numpy(cs.snake_nm(h, w)).to(dev), 10, 100,
                  [None, 16]))

    def time_ms(fn, n=10, reps=5):
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            torch.cuda.synchronize()
            samples.append(a.elapsed_time(b) / n)
        return float(np.median(samples))

    for label, nm, mn, mx, bands in cases:
        for band_h in bands:
            row, outs = {}, []
            # skip, every step, every step, skip: drift shows as a spread
            for which in ("skip", "every step", "every step", "skip"):
                _build._loaded[name] = libs[which]
                k4._scratch = Scratch()      # entries keep their library
                out, st = k4.banded_stats(nm, mn, mx, band_h=band_h)
                outs.append(out)
                row.setdefault(which, []).append(time_ms(
                    lambda: k4.hysteresis_banded(nm, mn, mx, band_h=band_h)))
                row["stats"] = st
            if not all(torch.equal(o, outs[0]) for o in outs):
                raise SystemExit(f"{label} band_h {band_h}: outputs differ")
            st = row["stats"]
            print(f"{label}, band_h {st['band_h']}: {st['sweeps']} sweeps, "
                  f"rounds max {st['rounds_max']} mean "
                  f"{st['rounds_sum'] / st['bands_run']:.2f}; ms skip "
                  f"{row['skip'][0]:.4f} {row['skip'][1]:.4f}, every step "
                  f"{row['every step'][0]:.4f} {row['every step'][1]:.4f}")
    _build._loaded[name] = libs["skip"]


if __name__ == "__main__":
    main()
