"""K1's device time over a sweep of Gaussian windows, for one tree of the port.

    python3 tools/k1_sweep.py [--tree DIR] [--label NAME] [--out DIR]
                              [--windows 17,19,...]

Builds K1 (``canny_edge_tpu_torch/kernels/csrc/frontend.cu``) of the tree
``DIR`` (default: this checkout; another one, unpacked with ``git archive``,
compares two versions in one call: run them in turns) and, at each window,
calls its wrapper ``kernels.frontend.frontend`` in threshold mode on a 1080p
frame (the headline frame of ``bench_torch.make_image`` with a disc of 255
and one of 0, whose edges a blur of 601 taps still leaves), holds the masks
equal to the plain version's (``ops/window.py:frontend_nm``), and measures:

- ``device_ms``: the kernels' device time a call (torch.profiler, 3 windows
  of 5 calls, the most complete window), by kernel name in ``by_kernel``;
- ``wall_ms``: CUDA events around 20 calls back to back, median of 5;
- ``bound_ms``: the hand bound of the same function at that window
  (``utils/roofline.py``: bytes read and written once, 4 window + 45
  operations a pixel at 33.5e12 a second, whichever is larger).

The window of a sigma is ``1 + 2 ceil(3 sigma)``; the tool takes sigma =
(window // 2 - 0.5) / 3.  Prints the card's name and power limit and one
JSON line, and with ``--out`` writes it to ``DIR/k1_sweep_<label>.json``.
Needs the CUDA toolkit and a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = (17, 19, 25, 31, 37, 49, 61, 121, 201, 263, 265, 301, 601)
MN, MX = 1, 3               # a 601-tap blur leaves steps of a few levels
HBM_BYTES_PER_S, OPS_PER_S = 3.35e12, 33.5e12


def sweep_frame(h, w, make_image):
    import numpy as np

    img = make_image(h, w, seed=0)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.hypot(xx, yy) < min(h, w) / 2] = 255
    img[np.hypot(xx - w, yy - h) < min(h, w) / 3] = 0
    return img


def device_ms(fn, sync, reps=5, tries=3):
    """{kernel name: device ms a call} from the window of ``reps`` calls
    that recorded the most launches; {} if none recorded any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    best, best_n = {}, 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        by, n = {}, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
                by[e.key[:48]] = us / 1e3 / reps
                n += e.count
        if n > best_n:
            best, best_n = by, n
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--windows", default=",".join(map(str, WINDOWS)))
    ap.add_argument("--hw", default="1080x1920")
    ap.add_argument("--out", help="directory for k1_sweep_<label>.json")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    from bench_torch import make_image
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import window as Wn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

    if not torch.cuda.is_available():
        sys.exit("k1_sweep: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    _build.load("frontend")
    h, w = map(int, args.hw.split("x"))
    img = torch.from_numpy(sweep_frame(h, w, make_image)).to(dev)
    wd = -(-w // 32)

    def sync():
        torch.cuda.synchronize()

    rows = {}
    for win in map(int, args.windows.split(",")):
        kern = gaussian_kernel((win // 2 - 0.5) / 3)
        assert len(kern) == win, (win, len(kern))
        taps = torch.from_numpy(kern).to(dev)
        ref = Wn.frontend_nm(img, kern)
        weak, strong = kfe.frontend(img, taps, (MN, MX))
        sync()
        same = (torch.equal(weak.view(torch.int32),
                            P.pack_mask(ref >= MN).view(torch.int32))
                and torch.equal(strong.view(torch.int32),
                                P.pack_mask(ref >= MX).view(torch.int32)))

        def fn(taps=taps):
            return kfe.frontend(img, taps, (MN, MX))

        by = device_ms(fn, sync)
        samples = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                fn()
            b.record()
            sync()
            samples.append(a.elapsed_time(b) / 20)
        tb = (h * w + 2 * h * wd * 4) / HBM_BYTES_PER_S * 1e3
        to = h * w * (4 * win + 45) / OPS_PER_S * 1e3
        rows[win] = {
            "path": kfe.k1_path(win, kfe.max_window(dev)),
            "equal": bool(same),
            "device_ms": sum(by.values()) if by else "not measured",
            "by_kernel": by, "wall_ms": float(np.median(samples)),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}
        print(win, json.dumps(rows[win]), flush=True)
    out = {"label": args.label, "tree": tree, "card": card, "hw": [h, w],
           "thresholds": [MN, MX], "max_window": kfe.max_window(dev),
           "windows": rows}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"k1_sweep_{args.label}.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not all(r["equal"] for r in rows.values()):
        sys.exit("k1_sweep: K1 differs from its plain version")


if __name__ == "__main__":
    main()
