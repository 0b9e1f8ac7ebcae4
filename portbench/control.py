#!/usr/bin/env python3
"""The readings that ``correct``'s limits were set from, on the card, at a
cell's own size and load: the program on many seeds (the lower reading) and
the control on a few (the upper reading), all in one process.

    python3 portbench/control.py --workload <name> --seconds 2 \\
        --seeds 11 12 ... --control-seeds 21 22 23

The control is the program's own path for given taps
(``CannyTorch.from_numpy_params``) fed the configuration's float32 Gaussian
taps rounded to bfloat16, the nearest precision below the one the
configuration states; it must come out not correct.  Each run is a whole
run of the cell (set-up, a short window, the sampled outputs against the
frozen oracle); one JSON line a run on standard output.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import run
    from portbench.harness import program
    from portbench.harness.device import require_cards

    run.pin_caches()
    cell = run.prepare(args.workload, 0, False)[0]
    require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    sides = [("program", s, program.make_model) for s in args.seeds] + \
        [("control", s, program.make_control_model)
         for s in args.control_seeds]
    for side, seed, make in sides:
        cell, driver, plan, readers = run.prepare(args.workload, seed, False)
        res = run.measure(cell, driver, plan, readers, seconds=args.seconds,
                          trace=False, device=device, make_model=make,
                          t_start=time.perf_counter())
        print(json.dumps({"workload": args.workload, "side": side,
                          "seed": seed, "correct": res["correct"],
                          "requests": res["info"]["requests"],
                          "check_s": res["info"]["check_s"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
