"""Smoke test of the PyTorch/CUDA port on one GPU: builds, checks and times
the kernels of both ported paths: ``CannyTorch``'s ``fused`` backend (K1
front end -> K2 packed flood -> unpack) and the ``pallas`` backend
(``canny_fused``: K1 in NMS mode -> K2, K3 tiled dilation or K4 banded
raster scan); then drives the command line (frames in, batched and staged
onto the card, K1 -> K2 a frame, PNGs out), the stage path and
``SobelTorch`` on the card, and the multi-device path (``ShardedCanny``:
K1 in block mode -> the distributed K2 flood) over meshes on the one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ``canny_edge_tpu_torch/kernels/csrc`` (nvcc)
     and the native feeder from ``canny_edge_tpu_torch/runtime/csrc`` (g++);
  3. K1 against its plain PyTorch version on the card, bit-equal, in nm and
     threshold mode (8 sigmas: every window the kernel unrolls, 3 to 15, and
     a generic one, 19; 1080p and 4K, shapes one off its 64x64 tile, W = 1,
     31, 33, 333, 1000, 1921; 3 threshold pairs, and one far outside the
     magnitudes);
  4. K2 against its plain versions, bit-equal, component and strict, in all
     four modes (packed masks or NMS map in, packed mask or int16 out): K1's
     maps at 1080p and 4K, a serpentine chain, a spiral, random maps and
     masks, ragged shapes; its step count held against the plain mirror of
     its tile schedule (at most the mirror's);
  5. the full ``CannyTorch`` path at 1080p and 4K (sigma 1.4, 30/90):
     ``__call__``, ``packed`` and ``batch_packed`` (B=4) in both modes, with
     every launch count set to 0 just before and read just after and no
     plain pack or unpack called, then held against the plain pipeline on
     the card; plus the card against the CPU on a small frame;
  6. times with CUDA events (median over many launches) of the kernels in
     each mode, their plain versions and the whole frame;
  7. K3 and K4 against their plain versions, bit-equal with equal sweep
     counts (K1's NMS maps at 1080p and 4K at 30/90 and 0/40, random maps,
     257x333, 64x33, 1x1000, 40x1; sparse chains 1000, 1921, 3840, 7680 and
     9000 columns wide: one, two, four and eight words a lane of K4 and its
     block-wide path; two tiles and two band heights), against K2 on the
     1080p serpentine and a 40x40 spiral, and 100 calls of each back to
     back on one frame, compared once at the end;
  8. the ``pallas`` path at 1080p and 4K (sigma 1.4, 30/90): ``canny_fused``
     with each hysteresis engine and ``CannyTorch(backend="pallas")`` /
     ``"xla"``, with every launch count set to 0 just before and read just
     after, then held against the plain pipeline on the card and against
     the CPU on a small frame; a ``banded`` or ``dilate`` frame is two
     kernels on the device (torch.profiler) and syncs with the host nowhere
     (20 calls queued behind a long one return before it ends);
  9. times of K3 and K4 (wall, host enqueue, device; sweeps, K4's rounds a
     band, K3's tile floods; plain versions) and of the frame for each
     engine and backend, and the device time (torch.profiler) of K1, K2 and
     the ``fused`` frame beside their wall times;
 10. the command-line path (``canny_edge_tpu_torch.cli``), each run with
     K1's and K2's counts from 0 and no plain pack or unpack allowed: a
     16-frame 1080p synthetic stream (batches of 4, prefetch 4), again with
     ``--packed-transfer``, ``--backend pallas`` and ``--resume`` after a
     stop halfway, a 4K stream, a ``raw8`` file and a PGM directory through
     the native feeder (and the PGM directory without it), and one ``python
     -m canny_edge_tpu_torch.cli``: every PNG, read back with the port's
     reader, equals ``CannyTorch``'s edges and each kernel ran once a frame;
     ``with_intermediates`` on the card at 1080p (``nonmax`` equal to K1's NMS
     map, edges to the fused frame, every intermediate and the dilation
     count to the CPU's), ``-s``'s three step images, ``SobelTorch`` card
     against CPU, ``--time``'s stage table; times: the stream of 64 frames
     at 1080p in batches of 8 by wall clock, the same stream without the
     model (their ratio), the stream of 64 ready 1080p frames from a
     ``raw8`` file three times (its spread) and once under
     ``utils.trace`` (the card's idle share), the stage path and
     ``SobelTorch`` a frame;
 11. the multi-device path: K1 at windows 17, 21, 25, 31, 33, 37 and 55 on
     1080p and 257x333, K1 block mode at each border class of a 4K frame
     (sigma 1.4 and 6.0) and K2 with the strict fix at (1, 1) of
     halo-extended blocks (the quirk image, the eight blocks of a 4K
     frame), each against its plain version; ``ShardedCanny`` on a 4K frame
     and 8 1080p frames over the real 1x1x1 mesh (a process group of one,
     NCCL) and in-process meshes 1x2x2, 1x2x4 and 2x2x2 on the one card,
     strict at 1x2x4 and the generic engine on 10x12, each bit-equal to the
     fused backend, with K1's block-mode and K2's quirk launches counted
     from 0; ``--backend sharded`` on 8 1080p frames against the fused
     PNGs; wall and device ms of the 4K sharded frame at each mesh and the
     flood's rounds a frame, printed on a ``multi-device:`` line.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Every measured number also goes to
standard error as one ``report:`` JSON line and to
``chiprun_out/chip_smoke_report.json`` beside this script.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM published peaks (NVIDIA data sheet): the HBM3 rate, and the float32
# rate outside the tensor cores.  That rate, 67e12, counts a fused
# multiply-add as two operations a lane a cycle.  These kernels may not fuse
# (the blur rounds every product and every sum on its own) and their other
# work is integer and bit operations, one a lane a cycle: their operation
# bound takes half the published rate.
HBM_BYTES_PER_S = 3.35e12
F32_FMA_OPS_PER_S = 67e12
SEPARATE_OPS_PER_S = F32_FMA_OPS_PER_S / 2
SIGMA, MN, MX = 1.4, 30, 90
SIZES = {"1080p": (1080, 1920), "4k": (2160, 3840)}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_image(h, w, seed=0):
    """The headline benchmark's frame: sinusoid, disc and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 96 + 64 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    img += 80 * (((xx - w / 2) ** 2 + (yy - h / 2) ** 2) < (min(h, w) / 3) ** 2)
    img += rng.normal(0, 6, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def snake_nm(h, w):
    """Serpentine weak chain with one strong seed: many flood steps."""
    nm = np.zeros((h, w), np.int32)
    for r in range(4, h - 4, 8):
        nm[r, 4:w - 4] = 30
    for i, r in enumerate(range(4, h - 12, 8)):
        c = w - 5 if i % 2 == 0 else 4
        nm[r:r + 9, c] = 30
    nm[4, 4] = 200
    return nm


def spiral_nm(n=40):
    """Inward spiral, one connected chain, strong seed at its centre end."""
    nm = np.zeros((n, n), np.int32)
    r0, c0, r1, c1 = 0, 0, n - 1, n - 1
    pts = []
    while r0 <= r1 and c0 <= c1:
        pts += [(r0, c) for c in range(c0, c1 + 1)]
        pts += [(r, c1) for r in range(r0 + 1, r1 + 1)]
        if r0 < r1:
            pts += [(r1, c) for c in range(c1 - 1, c0 - 1, -1)]
        if c0 < c1:
            pts += [(r, c0) for r in range(r1 - 1, r0 + 1, -1)]
            pts.append((r0 + 2, c0 + 1))
        r0, c0, r1, c1 = r0 + 2, c0 + 2, r1 - 2, c1 - 2
    for p in pts:
        nm[p] = 30
    nm[pts[-1]] = 200
    return nm


def sparse_nm(rng, h, w):
    """Thin weak chains with few seeds: several rounds and sweeps."""
    nm = np.zeros((h, w), np.int16)
    nm[rng.random((h, w)) < 0.58] = 30
    nm[rng.random((h, w)) < 0.002] = 200
    return nm


def random_nm(rng, h, w):
    nm = rng.integers(0, 100, (h, w)).astype(np.int16)
    nm[rng.random((h, w)) < 0.45] = 0
    return nm


def run_cli(argv, stderr=None):
    """``cli.main(argv)`` in this process: its ``--json`` stats."""
    from canny_edge_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(stderr or sys.stderr):
        rc = cli.main(argv)
    check(rc == 0, f"the command line exited {rc}: {argv}")
    return json.loads(out.getvalue())


def device_busy_s(trace_json):
    """Seconds in which the card ran a kernel, a copy or a fill in a Chrome
    trace of ``torch.profiler`` (the union of those events' intervals);
    ``None`` where the trace holds no device event."""
    with open(trace_json) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and str(e.get("cat", "")).lower()
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e6


def check_pngs(out_dir, refs, what):
    """Every ``edges_%06d.png`` in ``out_dir``, read back with the port's
    reader, equals its reference frame."""
    from canny_edge_tpu_torch.io import imageio

    names = sorted(f for f in os.listdir(out_dir) if f.startswith("edges_"))
    check(names == [f"edges_{i:06d}.png" for i in range(len(refs))],
          f"{what}: wrote {names[:3]}... ({len(names)}), not {len(refs)}")
    for i, ref in enumerate(refs):
        got = imageio.load_grayscale(os.path.join(out_dir, names[i]))
        check(np.array_equal(got, ref), f"{what}: frame {i} differs")


def command_line_phase(dev, time_ms, hw=SIZES["1080p"], hw4k=SIZES["4k"]):
    """Phase 10: the command-line path at 1080p and 4K (``hw``, ``hw4k``;
    ``cli.main`` in this process, and one ``python -m
    canny_edge_tpu_torch.cli``), the stage path and ``SobelTorch`` on the
    card, and their times.  Returns the report."""
    import torch

    from canny_edge_tpu_torch import CannyTorch, SobelTorch, cli
    from canny_edge_tpu_torch.io import imageio
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.kernels.hysteresis_packed import \
        hysteresis_packed_nm
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import stages as St
    from canny_edge_tpu_torch.utils.trace import trace

    rep = {}
    args = ["1.4", str(MN), str(MX)]
    model = CannyTorch(SIGMA)

    def refs_of(frames):
        return [model(f, MN, MX).cpu().numpy().astype(np.uint8)
                for f in frames]

    def counted(argv):
        """One run with K1's and K2's counts from 0 and the plain pack and
        unpack watched: (stats, counts)."""
        plain = dict(P.calls)
        kfe.launches = khp.launches = 0
        stats = run_cli(argv)
        counts = {"frontend": kfe.launches, "hysteresis_packed": khp.launches}
        check(P.calls == plain, f"the command line ran a plain pack/unpack: "
              f"{argv}")
        return stats, counts

    h, w = hw
    hd = f"{h}x{w}"
    frames = [imageio.synthetic_image(h, w, seed=i) for i in range(16)]
    refs = refs_of(frames)
    with tempfile.TemporaryDirectory(prefix="canny_cli_") as work:
        def d(name):
            return os.path.join(work, name)

        # the stream, 16 frames, batches of 4, and its variants
        runs = {}
        stream = [f"synthetic:{hd}x16", *args, "--batch", "4",
                  "--prefetch", "4", "--json"]
        for name, extra in (("fused", []), ("packed", ["--packed-transfer"]),
                            ("pallas", ["--backend", "pallas"])):
            stats, counts = counted(stream + ["--out-dir", d(name), *extra])
            check(stats["frames"] == 16 and counts == {
                "frontend": 16, "hysteresis_packed": 16},
                f"{name} stream: {stats['frames']} frames, launches {counts}")
            check_pngs(d(name), refs, f"{name} stream")
            runs[name] = {"stats": stats, "launches": counts}
        first, _ = counted([f"synthetic:{hd}x16", *args, "--batch", "4",
                            "--max-frames", "8", "--resume", "--json",
                            "--out-dir", d("resume")])
        stats, counts = counted(stream + ["--resume", "--out-dir",
                                          d("resume")])
        check(first["frames"] == 8 and stats["skipped_batches"] == 2
              and stats["frames"] == 8 and counts["frontend"] == 8
              and counts["hysteresis_packed"] == 8,
              f"resume: {first} then {stats}, launches {counts}")
        check_pngs(d("resume"), refs, "resumed stream")
        runs["resume"] = {"stats": stats, "launches": counts}

        # 4K
        frames4k = [imageio.synthetic_image(*hw4k, seed=i) for i in range(4)]
        stats, counts = counted([f"synthetic:{hw4k[0]}x{hw4k[1]}x4", *args, "--batch",
                                 "2", "--json", "--out-dir", d("4k")])
        check(counts == {"frontend": 4, "hysteresis_packed": 4},
              f"4K stream launches {counts}")
        check_pngs(d("4k"), refs_of(frames4k), "4K stream")
        runs["4k"] = {"stats": stats, "launches": counts}

        # the native feeder: a raw8 file and a PGM directory
        np.stack(frames[:8]).tofile(d("frames.raw"))
        stats, counts = counted([f"raw8:{d('frames.raw')}:{hd}x8", *args,
                                 "--batch", "4", "--native-feeder", "--json",
                                 "--out-dir", d("raw8")])
        check(counts["frontend"] == 8 and stats["feeder"]["produced"] == 8
              and stats["feeder"]["read_errors"] == 0,
              f"raw8: {stats}, launches {counts}")
        check_pngs(d("raw8"), refs[:8], "raw8 stream")
        runs["raw8"] = {"stats": stats, "launches": counts}
        os.makedirs(d("pgm"))
        for i, f in enumerate(frames[:4]):
            with open(os.path.join(d("pgm"), f"frame_{i:06d}.pgm"), "wb") as fh:
                fh.write(imageio.pgm_bytes(f))
        for name, extra in (("pgm_feeder", ["--native-feeder"]),
                            ("pgm_python", [])):
            stats, counts = counted([d("pgm"), *args, "--batch", "2",
                                     "--json", "--out-dir", d(name), *extra])
            check(counts["frontend"] == 4 and ("feeder" in stats) == bool(
                extra), f"{name}: {stats}, launches {counts}")
            check_pngs(d(name), refs[:4], name)
            runs[name] = {"stats": stats, "launches": counts}

        # one run as a user starts it
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "canny_edge_tpu_torch.cli",
             f"synthetic:{hd}x2", *args, "--json", "--out-dir", d("sub")],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        check(r.returncode == 0, f"python -m canny_edge_tpu_torch.cli exited "
              f"{r.returncode}: {r.stderr[-2000:]}")
        check_pngs(d("sub"), refs[:2], "python -m canny_edge_tpu_torch.cli")
        runs["subprocess"] = {"stats": json.loads(r.stdout.splitlines()[-1]),
                              "wall_s": time.perf_counter() - t}
        rep["runs"] = runs
        log("command line: " + ", ".join(
            f"{k} {v['stats']['frames']} frames {v.get('launches', '')}"
            for k, v in runs.items()))

        # the stage path on the card at 1080p
        img = frames[0]
        img_t = torch.from_numpy(img).to(dev)
        edges, inter = model.with_intermediates(img, MN, MX)
        edges_c, inter_c = CannyTorch(SIGMA, device="cpu").with_intermediates(
            img, MN, MX)
        check(torch.equal(inter["nonmax"], kfe.frontend(img_t, model.taps)),
              "with_intermediates' nonmax differs from K1's NMS map")
        check(np.array_equal(edges.cpu().numpy().astype(np.uint8), refs[0]),
              "with_intermediates' edges differ from the fused frame")
        check(torch.equal(edges.cpu(), edges_c), "stage path: card and CPU "
              "edges differ")
        for k in ("smoothed", "magnitude", "angle", "nonmax"):
            check(inter[k].device == dev and torch.equal(inter[k].cpu(),
                                                         inter_c[k]),
                  f"with_intermediates' {k}: card and CPU differ")
        check(inter["frontier_iterations"] == inter_c["frontier_iterations"],
              f"frontier iterations: card {inter['frontier_iterations']}, "
              f"CPU {inter_c['frontier_iterations']}")
        imageio.save_png(d("in.png"), img)
        run_cli([d("in.png"), *args, "-s", "-o", d("s_edges.png"),
                 "--out-dir", d("steps"), "--json"])
        check(np.array_equal(imageio.load_grayscale(d("s_edges.png")),
                             refs[0]), "-s: the edge image differs")
        for k in ("smoothed", "magnitude", "nonmax"):
            got = imageio.load_grayscale(os.path.join(d("steps"),
                                                      f"step_{k}.png"))
            check(np.array_equal(got, imageio.minmax_normalize_u8(
                inter_c[k].numpy())), f"-s: step_{k}.png differs")
        sob, sob_c = SobelTorch(SIGMA), SobelTorch(SIGMA, device="cpu")
        pair = np.stack(frames[:2])
        check(torch.equal(sob(img, 80).cpu(), sob_c(img, 80))
              and torch.equal(sob.magnitude(img).cpu(), sob_c.magnitude(img))
              and torch.equal(sob.batch(pair, 80).cpu(), sob_c.batch(pair, 80)),
              "SobelTorch: card and CPU differ")
        rep["frontier_iterations"] = inter["frontier_iterations"]
        log("stage path and SobelTorch on the card equal the CPU")

        # --time: the stage table at 1080p
        err = io.StringIO()
        stats = run_cli([f"synthetic:{hd}x1", *args, "--time", "--json",
                         "--out-dir", d("time")], stderr=err)
        table = [ln for ln in err.getvalue().splitlines()
                 if ln.split()[:1] and ln.split()[0] in (
                     "stage", "gaussian", "sobel", "nms", "hysteresis",
                     "TOTAL")]
        check(len(table) == 6 and "[slope]" in table[0]
              and stats["stages"]["protocol"] == "slope",
              f"--time printed {err.getvalue()[-500:]}")
        rep["stages_1080p"] = stats["stages"]

        # times: the stream by wall clock, and the same without the model
        big = [f"synthetic:{hd}x64", *args, "--batch", "8", "--json"]
        t = time.perf_counter()
        stats = run_cli(big + ["--out-dir", d("big")])
        wall = time.perf_counter() - t
        edges8 = model.batch(np.stack(frames[:8]), MN, MX)
        make_run_batch = cli._make_run_batch
        cli._make_run_batch = lambda cfg, device, first: (lambda b: edges8, None)
        t = time.perf_counter()
        bare = run_cli(big + ["--out-dir", d("bare")])
        bare_wall = time.perf_counter() - t
        cli._make_run_batch = make_run_batch

        # the stream of ready frames: 64 from a raw8 file (8 frames over
        # again) through the feeder, three times by wall clock, then once
        # traced for the time the card was busy
        np.tile(np.stack(frames[:8]), (8, 1, 1)).tofile(d("ready.raw"))
        ready = [f"raw8:{d('ready.raw')}:{hd}x64", *args, "--batch", "8",
                 "--native-feeder", "--json"]
        ready_runs = [run_cli(ready + ["--out-dir", d(f"ready{i}")])
                      for i in range(3)]
        kfe.launches = khp.launches = 0
        with trace(d("trace")):
            traced = run_cli(ready + ["--out-dir", d("ready_traced")])
        check(kfe.launches == 64 and khp.launches == 64,
              f"traced ready stream: launches {kfe.launches}, "
              f"{khp.launches}")
        check_pngs(d("ready_traced"), refs[:8] * 8, "traced ready stream")
        busy = device_busy_s(os.path.join(d("trace"), "trace.json"))
        pixels = h * w
        kern = model.kernel

        def stage_prefix():
            sm = St._gaussian_blur_with_kernel(img_t, kern)
            return hysteresis_packed_nm(St.nonmax_suppression(*St.sobel(sm)),
                                        MN, MX)

        rep["times"] = {
            "stream_64x1080p_b8": {
                "fps": stats["fps"], "mp_per_s": stats["mp_per_s"],
                "stream_s": stats["seconds"], "wall_s": wall},
            "stream_without_model": {
                "fps": bare["fps"], "stream_s": bare["seconds"],
                "wall_s": bare_wall},
            # not a share: at >= 1 the model is lost in the host's noise
            "without_model_ratio": bare["seconds"] / stats["seconds"],
            "ready_64x1080p_b8": {
                "fps": [r["fps"] for r in ready_runs],
                "mp_per_s": [r["mp_per_s"] for r in ready_runs],
                "stream_s": [r["seconds"] for r in ready_runs]},
            "ready_traced": {
                "fps": traced["fps"], "stream_s": traced["seconds"],
                "device_busy_s": busy,
                "idle_share": (None if busy is None
                               else 1 - busy / traced["seconds"])},
            "with_intermediates_ms": time_ms(
                lambda: model.with_intermediates(img_t, MN, MX), 3, 3),
            "stage_prefix_ms": time_ms(stage_prefix, 10, 3),
            "sobel_ms": time_ms(lambda: sob(img_t, 80), 10, 3),
            "sobel_magnitude_ms": time_ms(lambda: sob.magnitude(img_t), 10, 3),
            "fused_frame_ms": time_ms(lambda: model(img_t, MN, MX), 20, 3),
        }
    tm = rep["times"]
    tm["stage_path_s_per_px"] = tm["stage_prefix_ms"] / 1e3 / pixels
    print(f"command line, 64 frames 1080p, batch 8: "
          f"{tm['stream_64x1080p_b8']['fps']} frames/s, "
          f"{tm['stream_64x1080p_b8']['mp_per_s']} MP/s (stream "
          f"{tm['stream_64x1080p_b8']['stream_s']} s, wall "
          f"{wall:.3f} s); without the model {bare['seconds']} s: ratio "
          f"{tm['without_model_ratio']:.3f}"
          + (" (>= 1: the model is lost in the host's noise, uninformative)"
             if tm["without_model_ratio"] >= 1 else ""), flush=True)
    rd, tr = tm["ready_64x1080p_b8"], tm["ready_traced"]
    idle = ("not measured (no device event in the trace)"
            if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
    print(f"command line, 64 ready frames 1080p (raw8, feeder), batch 8: "
          f"{rd['fps']} frames/s, {rd['mp_per_s']} MP/s; traced "
          f"{tr['fps']} frames/s, card busy {tr['device_busy_s']} s of "
          f"{tr['stream_s']} s: idle share {idle}", flush=True)
    print("stage table, 1080p:", flush=True)
    for ln in table:
        print("  " + ln, flush=True)
    print(f"per 1080p frame: with_intermediates {tm['with_intermediates_ms']:.3f}"
          f" ms ({rep['frontier_iterations']} dilations), stage prefix "
          f"{tm['stage_prefix_ms']:.3f} ms ({tm['stage_path_s_per_px']:.3e} "
          f"s/px), SobelTorch {tm['sobel_ms']:.3f} ms, fused frame "
          f"{tm['fused_frame_ms']:.4f} ms", flush=True)
    return rep


def multi_device_phase(dev, time_ms, device_ms, hw=SIZES["1080p"],
                       hw4k=SIZES["4k"], odd=(257, 333), batch=8):
    """Phase 11: the multi-device path on the card.  K1 at windows 17 to 55
    and in block mode, K2 with the strict fix at (1, 1), each against its
    plain version; ``ShardedCanny`` at 4K (``hw4k``) and on ``batch`` frames
    of ``hw`` over the real 1x1x1 mesh (a ``torch.distributed`` group of one)
    and in-process meshes of 4 and 8 blocks on the one card, bit-equal to
    ``CannyTorch``'s fused frames, with K1's block-mode and K2's quirk
    launches counted from 0; strict mode at 1x2x4, the generic engine; the
    command line's ``--backend sharded``.  Returns the report."""
    import socket

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from canny_edge_tpu_torch import CannyTorch
    from canny_edge_tpu_torch.io import imageio
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import window as Wn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from canny_edge_tpu_torch.parallel import ShardedCanny, make_mesh
    from canny_edge_tpu_torch.parallel import multihost

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def u32eq(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    rep = {}
    t0 = time.perf_counter()
    # ---- K1 at the windows of the generic instantiation, up to 55 ----
    windows = set()
    k1_err = 0
    for sigma in (2.5, 3.2, 3.9, 4.9, 5.2, 6.0, 9.0):
        kern = gaussian_kernel(sigma)
        windows.add(len(kern))
        taps = torch.from_numpy(kern).to(dev)
        for h, w in (hw, odd):
            img = torch.from_numpy(make_image(h, w, seed=h + len(kern))).to(dev)
            ref = Wn.frontend_nm(img, kern)
            nm = kfe.frontend(img, taps).to(torch.int32)
            weak, strong = kfe.frontend(img, taps, (MN, MX))
            sync()
            k1_err = max(k1_err, int((nm - ref).abs().max()))
            check(torch.equal(nm, ref)
                  and u32eq(weak, P.pack_mask(ref >= MN))
                  and u32eq(strong, P.pack_mask(ref >= MX)),
                  f"K1 differs at window {len(kern)}, {h}x{w}")
    check(windows == {17, 21, 25, 31, 33, 37, 55}, f"K1 windows {windows}")
    rep["k1_windows"] = {"windows": sorted(windows), "max_abs_err": k1_err,
                         "s": time.perf_counter() - t0}
    log(f"K1 bit-equal at windows {sorted(windows)}")

    # ---- K1 block mode at every border class of a 4K frame ----
    t0 = time.perf_counter()
    H, W = hw4k
    frame4k = make_image(H, W, seed=4)
    img4k = torch.from_numpy(frame4k).to(dev)
    hl, wl = H // 2, -(-(W // 4) // 32) * 32        # a block of a 1x2x4 mesh
    blocks = {"top_left": (0, 0, hl, wl), "interior": (0, wl, hl, wl),
              "bottom_right": (H - hl, W - wl, hl, wl),
              "full_width": (H - hl, 0, hl, W),
              "past_the_image": (H - 40, W - 32, 64, 64)}
    block_err = 0
    for sigma in (SIGMA, 6.0):
        kern = gaussian_kernel(sigma)
        taps = torch.from_numpy(kern).to(dev)
        r = len(kern) // 2 + 2
        pad = F.pad(img4k, (r, r + 64, r, r + 64))
        for name, (row0, col0, bh, bw) in blocks.items():
            win = pad[row0:row0 + bh + 2 * r, col0:col0 + bw + 2 * r].contiguous()
            nm = kfe.frontend_block(win, row0, col0, H, W, taps).to(torch.int32)
            ref = Wn.frontend_block(win, row0, col0, H, W, kern)
            got = kfe.frontend_block(win, row0, col0, H, W, taps, (MN, MX))
            want = Wn.frontend_block(win, row0, col0, H, W, kern, (MN, MX))
            sync()
            block_err = max(block_err, int((nm - ref).abs().max()))
            check(torch.equal(nm, ref) and all(u32eq(a, b) for a, b in
                                               zip(got, want)),
                  f"K1 block mode differs: sigma {sigma} {name}")
    rep["k1_block"] = {"blocks": list(blocks), "max_abs_err": block_err,
                       "s": time.perf_counter() - t0}
    log(f"K1 block mode bit-equal at {list(blocks)}, sigma {SIGMA} and 6.0")

    # ---- K2 with the strict fix at (1, 1) of halo-extended blocks ----
    t0 = time.perf_counter()
    taps14 = torch.from_numpy(gaussian_kernel(SIGMA)).to(dev)

    def extended(masks, y, x, bh, bwd):
        """The (bh + 2, bwd + 2) words of block (y, x) with a halo of one
        row and one word, zero past the image."""
        return [F.pad(m.view(torch.int32), (1, 1, 1, 1))[
            y * bh:(y + 1) * bh + 2, x * bwd:(x + 1) * bwd + 2]
            .contiguous().view(torch.uint32) for m in masks]

    quirk_img = np.zeros((128, 256), np.uint8)     # tests/test_strict_mode.py
    quirk_img[0:4, 0:5] = [[122, 140, 225, 71, 74], [230, 67, 252, 59, 57],
                           [136, 47, 164, 232, 168], [128, 9, 222, 235, 150]]
    quirk_img[64, 128] = 200
    cases = {"quirk_image": extended(kfe.frontend(
        torch.from_numpy(quirk_img).to(dev),
        torch.from_numpy(gaussian_kernel(0.5)).to(dev), (144, 145)),
        0, 0, 64, 2)}
    masks4k = kfe.frontend(img4k, taps14, (MN, MX))
    for y in range(2):
        for x in range(4):
            cases[f"4k_block_{y}{x}"] = extended(masks4k, y, x, hl, wl // 32)
    k2_err = 0
    quirk_bit = {}
    for name, (weak, strong) in cases.items():
        h, w = weak.shape[0], weak.shape[1] * 32
        for strict in (False, True):
            ref, _ = P.hysteresis_packed_masks(weak, strong, h, w,
                                               strict=strict, quirk_rw=(1, 1))
            out = khp.hysteresis_packed(weak, strong, h, w, strict=strict,
                                        quirk_rw=(1, 1))
            sync()
            k2_err = max(k2_err, int((P.unpack_edges(out, w)
                                      - P.unpack_edges(ref, w)).abs().max()) // 255)
            check(u32eq(out, ref), f"K2 with quirk (1, 1) differs: {name} "
                  f"strict={strict}")
            if name == "quirk_image":        # global pixel (0, 1)
                quirk_bit[strict] = int(P.from_words(out)[1, 1]) >> 1 & 1
    check(quirk_bit == {False: 1, True: 0},
          f"the quirk image's pixel (0, 1) is {quirk_bit} by strict mode")
    rep["k2_quirk"] = {"cases": list(cases), "max_abs_err": k2_err,
                       "s": time.perf_counter() - t0}
    log(f"K2 with quirk (1, 1) bit-equal on {len(cases)} extended blocks x 2 modes")

    # ---- ShardedCanny on the card: the main path, counts from 0 ----
    t0 = time.perf_counter()
    frames = np.stack([make_image(*hw, seed=10 + i) for i in range(batch)])
    pair4k = np.stack([frame4k, make_image(H, W, seed=5)])
    fused = {m: CannyTorch(SIGMA, hysteresis_mode=m, device=dev)
             for m in ("component", "strict-reference")}
    ref4k = fused["component"].batch(pair4k, MN, MX)
    ref_batch = fused["component"].batch(frames, MN, MX)
    ref_strict = fused["strict-reference"](frame4k, MN, MX)
    tiny = make_image(10, 12, seed=6)
    ref_tiny = CannyTorch(2.0, device=dev)(tiny, MN, MX)
    sync()
    in_process = [(1, 2, 2), (1, 2, 4), (2, 2, 2)]
    models = {}
    kfe.launches = kfe.block_launches = 0
    khp.launches = khp.quirk_launches = 0
    outs = {}
    # the real mesh: a process group of one (NCCL on the card)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    check(multihost.initialize(f"localhost:{port}", 1, 0, device=dev.type)
          == (0, 1), "the process group did not start")
    try:
        mesh = make_mesh()
        check(mesh.ranks is not None and mesh.size == 1,
              f"the real mesh is {mesh}")
        models["1x1x1"] = ShardedCanny(mesh, SIGMA, (H, W))
        models["1x1x1_1080p"] = ShardedCanny(mesh, SIGMA, hw)
        outs["1x1x1"] = models["1x1x1"](pair4k[:1], MN, MX)
        outs["1x1x1_1080p"] = models["1x1x1_1080p"](frames, MN, MX)
        sync()
    finally:
        dist.destroy_process_group()
    for d, y, x in in_process:
        tag = f"{d}x{y}x{x}"
        mesh = make_mesh([dev] * (d * y * x), data=d, y=y, x=x)
        models[tag] = ShardedCanny(mesh, SIGMA, (H, W))
        models[f"{tag}_1080p"] = ShardedCanny(mesh, SIGMA, hw)
        outs[tag] = models[tag](pair4k[:d], MN, MX)
        outs[f"{tag}_1080p"] = models[f"{tag}_1080p"](frames, MN, MX)
    strict_mesh = make_mesh([dev] * 8, y=2, x=4)
    models["strict_1x2x4"] = ShardedCanny(strict_mesh, SIGMA, (H, W),
                                          hysteresis_mode="strict-reference")
    outs["strict_1x2x4"] = models["strict_1x2x4"](frame4k[None], MN, MX)
    models["generic_1x2x4"] = ShardedCanny(strict_mesh, 2.0, (10, 12))
    outs["generic_1x2x4"] = models["generic_1x2x4"](tiny[None], MN, MX)
    sync()
    counts = {"frontend": kfe.launches, "frontend_block": kfe.block_launches,
              "hysteresis_packed": khp.launches,
              "hysteresis_packed_quirk": khp.quirk_launches}
    log(f"multi-device launches: {counts}")
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the multi-device path was not launched: {counts}")
    check(models["generic_1x2x4"].engine == "generic"
          and all(m.engine == "static" and m.flood == "vmem"
                  for k, m in models.items() if k != "generic_1x2x4"),
          "engine or flood not as expected")
    rounds = {}
    for tag, out in outs.items():
        if tag == "strict_1x2x4":
            want = ref_strict[None]
        elif tag == "generic_1x2x4":
            want = ref_tiny[None]
        elif tag.endswith("_1080p"):
            want = ref_batch
        else:
            want = ref4k[:out.shape[0]]
        check(out.dtype == torch.int16 and torch.equal(out, want),
              f"ShardedCanny {tag} differs from the fused backend")
        rounds[tag] = list(models[tag].rounds)
    rep["sharded_check"] = {"meshes": list(outs), "rounds_per_frame": rounds,
                            "launches": counts,
                            "s": time.perf_counter() - t0}
    log(f"ShardedCanny bit-equal to the fused backend on {list(outs)}; "
        f"rounds a frame {rounds}")

    # ---- times of the 4K sharded frame at each mesh ----
    t0 = time.perf_counter()
    times = {}
    for tag in ["1x1x1"] + [f"{d}x{y}x{x}" for d, y, x in in_process]:
        model = models[tag]
        if tag == "1x1x1":      # the group is gone: the same one block
            model = ShardedCanny(make_mesh([dev]), SIGMA, (H, W))
        n = model.mesh.shape["data"]
        imgs = torch.from_numpy(pair4k[:n]).to(dev)

        def call():
            return model(imgs, MN, MX)

        call()
        sync()
        walls = []
        for _ in range(3):
            ta = time.perf_counter()
            call()
            sync()
            walls.append((time.perf_counter() - ta) * 1e3 / n)
        by = device_ms(call)
        times[tag] = {"wall_ms": float(np.median(walls)),
                      "device_ms": sum(by.values()) / n if by else
                      "not measured",
                      "device_by_kernel": by,
                      "rounds_per_frame": list(model.rounds)}
    fused4k = fused["component"]
    times["fused_frame_4k_ms"] = time_ms(lambda: fused4k(img4k, MN, MX), 10, 3)
    rep["sharded_4k_times"] = times
    rep["sharded_times_s"] = time.perf_counter() - t0

    # ---- the kernels' own times at a 4K block (the kernels line) ----
    r = len(gaussian_kernel(SIGMA)) // 2 + 2
    kern = gaussian_kernel(SIGMA)
    win = F.pad(img4k, (r, r, r, r))[0:hl + 2 * r, wl:2 * wl + 2 * r].contiguous()
    weak, strong = cases["4k_block_00"]
    eh, ew = weak.shape[0], weak.shape[1] * 32

    def k1_block():
        return kfe.frontend_block(win, 0, wl, H, W, taps14, (MN, MX))

    def k2_quirk():
        return khp.hysteresis_packed(weak, strong, eh, ew, strict=True,
                                     quirk_rw=(1, 1))

    kt = {
        "k1_block_ms": time_ms(k1_block, 50),
        "k1_block_plain_ms": time_ms(lambda: Wn.frontend_block(
            win, 0, wl, H, W, kern, (MN, MX)), 3, 3),
        "k2_quirk_ms": time_ms(k2_quirk, 50),
        "k2_quirk_plain_ms": time_ms(lambda: P.hysteresis_packed_masks(
            weak, strong, eh, ew, strict=True, quirk_rw=(1, 1)), 3, 3),
        "k2_quirk_steps": int(khp.hysteresis_packed(
            weak, strong, eh, ew, strict=True, quirk_rw=(1, 1),
            return_steps=True)[1]),
    }
    for key, fn in (("k1_block", k1_block), ("k2_quirk", k2_quirk)):
        by = device_ms(fn)
        kt[f"{key}_device_ms"] = sum(by.values()) if by else "not measured"
    # K1 block: the window read once, the two masks written once; per pixel
    # as K1 (phase 6).  K2: two masks read and one written, ~40 operations
    # a word
    wd = wl // 32
    for k, b, o in (("k1_block", win.numel() + 2 * hl * wd * 4,
                     hl * wl * (4 * len(kern) + 45)),
                    ("k2_quirk", 3 * eh * (ew // 32) * 4,
                     40 * eh * (ew // 32))):
        tb, to = b / HBM_BYTES_PER_S * 1e3, o / SEPARATE_OPS_PER_S * 1e3
        kt[f"{k}_bound_ms"] = max(tb, to)
        kt[f"{k}_bound_by"] = "bytes" if tb >= to else "operations"
    rep["kernel_times"] = kt
    rep["max_abs_err"] = {"frontend_block": block_err, "k2_quirk": k2_err}

    # ---- the command line: --backend sharded against the fused PNGs ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec = f"synthetic:{hw[0]}x{hw[1]}x{batch}"
        base = [spec, "1.4", str(MN), str(MX), "--batch", str(batch),
                "--json", "--device", dev.type]
        kfe.block_launches = khp.launches = 0
        sharded = run_cli(base + ["--backend", "sharded", "--out-dir",
                                  os.path.join(tmp, "sharded")])
        check(kfe.block_launches == batch and khp.launches == batch,
              f"the sharded command line launched K1 block {kfe.block_launches}"
              f" and K2 {khp.launches} times for {batch} frames")
        run_cli(base + ["--out-dir", os.path.join(tmp, "fused")])
        for i in range(batch):
            a, b = (imageio.load_grayscale(os.path.join(
                tmp, d, f"edges_{i:06d}.png")) for d in ("sharded", "fused"))
            check(np.array_equal(a, b) and a.any(),
                  f"sharded command line frame {i} differs from fused")
    rep["cli_sharded"] = {"frames": batch, "fps": sharded["fps"],
                          "s": time.perf_counter() - t0}
    log(f"command line --backend sharded equals fused on {batch} frames")
    return rep


def main():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    t_run = time.perf_counter()
    from canny_edge_tpu_torch import CannyTorch, runtime
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis as k3
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
    from canny_edge_tpu_torch.kernels.fused import IMPLS, canny_fused
    from canny_edge_tpu_torch.ops import banded as Bd
    from canny_edge_tpu_torch.ops import dilate as Dl
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import packed_tiles as Tl
    from canny_edge_tpu_torch.ops import window as Wn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    report = {}

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    report["card"] = card
    report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"

    # ---- 2. build (the native feeder with g++ beside the kernels) ----
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        feeder_build = pool.submit(runtime.build)
        built = _build.build_all()
        feeder_lib = feeder_build.result()
    report["build_s"] = time.perf_counter() - t0
    check(runtime.available(), f"the native feeder does not load: {feeder_lib}")
    log(f"build: {report['build_s']:.1f}s {built}, feeder {feeder_lib.name}")
    print(f"build seconds: {report['build_s']:.1f}", flush=True)

    def sync():
        torch.cuda.synchronize()

    def u32eq(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    # ---- 3. K1 against its plain version ----
    t0 = time.perf_counter()
    k1_cases = 0
    k1_err = 0
    k1_windows = set()
    # windows 3, 5, 7, 9, 11, 13, 15 (each unrolled) and 19 (the generic one)
    for sigma in (0.3, 0.5, 1.0, 1.2, 1.4, 2.0, 2.3, 3.0):
        kern = gaussian_kernel(sigma)
        k1_windows.add(len(kern))
        taps = torch.from_numpy(kern).to(dev)
        shapes = list(SIZES.values()) + [
            (257, 333), (1, 50), (50, 1), (3, 200),
            (63, 65), (65, 63), (64, 64), (129, 127),           # tile +- 1
            (40, 1), (40, 31), (40, 33), (70, 1000), (70, 1921)]
        for h, w in shapes:
            img = torch.from_numpy(make_image(h, w, seed=h + w)).to(dev)
            ref = Wn.frontend_nm(img, kern)
            nm = kfe.frontend(img, taps)
            sync()
            k1_err = max(k1_err, int((nm.to(torch.int32) - ref).abs().max()))
            check(torch.equal(nm.to(torch.int32), ref),
                  f"K1 nm differs: sigma {sigma} {h}x{w}")
            pairs = [(30, 90), (0, 40), (50, 150)]
            if (h, w) == (257, 333):
                pairs.append((-2**31, 2**30))
            for mn, mx in pairs:
                weak, strong = kfe.frontend(img, taps, (mn, mx))
                sync()
                check(u32eq(weak, P.pack_mask(ref >= mn))
                      and u32eq(strong, P.pack_mask(ref >= mx)),
                      f"K1 masks differ: sigma {sigma} {h}x{w} {mn}/{mx}")
            k1_cases += 1
    check(k1_windows == {3, 5, 7, 9, 11, 13, 15, 19},
          f"K1 windows checked: {sorted(k1_windows)}")
    report["k1_check"] = {"cases": k1_cases, "windows": sorted(k1_windows),
                          "s": time.perf_counter() - t0}
    log(f"K1 bit-equal on {k1_cases} image cases x 4 modes, windows "
        f"{sorted(k1_windows)}")

    # ---- 4. K2 against its plain versions, all four modes ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    taps14 = torch.from_numpy(gaussian_kernel(SIGMA)).to(dev)
    # name -> (NMS map or None, (weak, strong), h, w, lo, hi)
    flood_cases = {}

    def add_nm_case(name, nm, lo, hi):
        nm = torch.as_tensor(nm).to(dev)
        flood_cases[name] = (nm, (P.pack_mask(nm >= lo), P.pack_mask(nm >= hi)),
                             nm.shape[0], nm.shape[1], lo, hi)

    for name, (h, w) in SIZES.items():
        img = torch.from_numpy(make_image(h, w)).to(dev)
        add_nm_case(f"k1_nm_{name}", kfe.frontend(img, taps14), MN, MX)
    add_nm_case("snake_1080p", snake_nm(1080, 1920), 10, 100)
    add_nm_case("spiral_40", spiral_nm(), 10, 100)
    add_nm_case("random_nm_1080p", random_nm(rng, 1080, 1920), 10, 95)
    quirk = np.zeros((16, 64), np.int32)
    quirk[1, 0], quirk[8, 40] = 10, 10   # strong
    quirk[0, 1:10], quirk[8, 30:60] = 3, 5   # weak runs; the first is
    # reachable only through the promotion strict mode excludes
    add_nm_case("quirk_16x64", quirk, 2, 10)
    for h, w in ((64, 33), (1, 1000), (1, 1), (40, 1), (40, 31), (257, 333),
                 (63, 65), (65, 63), (129, 127), (9, 1025), (70, 1000),
                 (70, 1921)):
        add_nm_case(f"random_{h}x{w}", random_nm(rng, h, w), MN, MX)
    for dens in (0.5, 0.6):                # masks only: no NMS map
        weak = rng.random((1080, 1920)) < dens
        strong = weak & (rng.random((1080, 1920)) < 0.002)
        flood_cases[f"random_{dens}"] = (
            None, (P.pack_mask(torch.from_numpy(weak).to(dev)),
                   P.pack_mask(torch.from_numpy(strong).to(dev))),
            1080, 1920, 0, 0)
    k2_steps = {}
    k2_err = 0
    k2_modes = 0
    for name, (nm, (weak, strong), h, w, lo, hi) in flood_cases.items():
        for strict in (False, True):
            tag = f"{name}/{'strict' if strict else 'component'}"
            ref, rounds = P.hysteresis_packed_masks(weak, strong, h, w,
                                                    strict=strict)
            ref16 = P.unpack_edges(ref, w)
            _, mirror_steps, mirror_floods = Tl.hysteresis_packed_tiles(
                weak.cpu(), strong.cpu(), h, w, strict=strict)
            calls = dict(P.calls)
            out, steps = khp.hysteresis_packed(weak, strong, h, w,
                                               strict=strict, return_steps=True)
            out16 = khp.hysteresis_packed(weak, strong, h, w, strict=strict,
                                          edges_int16=True)
            outs = [out, out16]
            if nm is not None:
                for t in (nm.to(torch.int16), nm.to(torch.int32)):
                    outs.append(khp.hysteresis_packed_nm(
                        t, lo, hi, strict=strict, packed_out=True))
                    outs.append(khp.hysteresis_packed_nm(t, lo, hi,
                                                         strict=strict))
            sync()
            check(P.calls == calls, f"K2 ran a plain pack/unpack: {tag}")
            for o in outs:
                if o.dtype == torch.int16:
                    check(o.shape == (h, w) and torch.equal(o, ref16),
                          f"K2 int16 output differs: {tag}")
                else:
                    check(u32eq(o, ref), f"K2 packed output differs: {tag}")
                k2_modes += 1
            # largest per-pixel difference (edge bits are 0 or 1)
            k2_err = max(k2_err, int((out16 - ref16).abs().max()) // 255)
            check(1 <= int(steps) <= mirror_steps,
                  f"K2 took {int(steps)} steps, its mirror {mirror_steps}: "
                  f"{tag}")
            k2_steps[tag] = {
                "kernel_steps": int(steps), "mirror_steps": mirror_steps,
                "mirror_floods": mirror_floods, "plain_rounds": rounds}
    report["k2_check"] = {"steps": k2_steps, "outputs": k2_modes,
                          "s": time.perf_counter() - t0}
    log(f"K2 bit-equal on {len(flood_cases)} cases x 2 modes, {k2_modes} "
        f"outputs: {k2_steps}")

    # ---- 5. the main path: CannyTorch, launch counts from 0 ----
    t0 = time.perf_counter()
    frames = {name: [make_image(h, w, seed=s) for s in range(4)]
              for name, (h, w) in SIZES.items()}
    models = {m: CannyTorch(SIGMA, hysteresis_mode=m)
              for m in ("component", "strict-reference")}
    kfe.launches = 0
    khp.launches = 0
    plain_calls = dict(P.calls)
    outs = {}
    for mode, model in models.items():
        for name, fr in frames.items():
            outs[mode, name, "call"] = model(fr[0], MN, MX)
            outs[mode, name, "packed"] = model.packed(fr[0], MN, MX)
            outs[mode, name, "batch_packed"] = model.batch_packed(
                np.stack(fr), MN, MX)
    sync()
    counts = {"frontend": kfe.launches, "hysteresis_packed": khp.launches}
    log(f"main path launches: {counts}")
    check(counts["frontend"] > 0 and counts["hysteresis_packed"] > 0,
          f"a kernel of the main path was not launched: {counts}")
    check(P.calls == plain_calls,
          f"the main path called a plain pack/unpack: {P.calls} from "
          f"{plain_calls}")

    def plain_packed(img, strict):
        h, w = img.shape
        weak, strong = Wn.frontend_nm(img, gaussian_kernel(SIGMA), (MN, MX))
        return P.hysteresis_packed_masks(weak, strong, h, w, strict=strict)[0]

    for mode in models:
        strict = mode == "strict-reference"
        for name, fr in frames.items():
            refs = [plain_packed(torch.from_numpy(f).to(dev), strict)
                    for f in fr]
            got = outs[mode, name, "call"]
            check(got.dtype == torch.int16 and got.shape == fr[0].shape,
                  f"__call__ output {got.dtype} {tuple(got.shape)}")
            check(torch.equal(got, P.unpack_edges(refs[0], fr[0].shape[1])),
                  f"__call__ differs: {mode} {name}")
            check(u32eq(outs[mode, name, "packed"], refs[0]),
                  f"packed differs: {mode} {name}")
            check(u32eq(outs[mode, name, "batch_packed"], torch.stack(refs)),
                  f"batch_packed differs: {mode} {name}")
            edge_px = int((got == 255).sum())
            check(0 < edge_px < got.numel() // 4,
                  f"implausible edge count {edge_px}: {mode} {name}")
            report.setdefault("edge_px", {})[f"{mode}/{name}"] = edge_px
    small = make_image(256, 256, seed=3)
    for mode, model in models.items():
        cpu = CannyTorch(SIGMA, hysteresis_mode=mode, device="cpu")
        check(torch.equal(model(small, MN, MX).cpu(), cpu(small, MN, MX)),
              f"card and CPU differ on 256x256: {mode}")
    report["main_path"] = {"launches": counts, "s": time.perf_counter() - t0}
    log("main path bit-equal to the plain pipeline")

    # ---- 6. times ----
    t0 = time.perf_counter()

    def time_ms(fn, n=20, reps=5):
        fn()
        sync()
        samples = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            sync()
            samples.append(a.elapsed_time(b) / n)
        return float(np.median(samples))

    def host_ms(fn, n=200):
        """Host time to enqueue one call: n calls back to back, the queue
        empty at the start and deep enough never to block."""
        fn()
        sync()
        t_start = time.perf_counter()
        for _ in range(n):
            fn()
        per_call = (time.perf_counter() - t_start) / n * 1e3
        sync()
        return per_call

    model = models["component"]
    times = {}
    for name, (h, w) in SIZES.items():
        img = torch.from_numpy(frames[name][0]).to(dev)
        weak, strong = kfe.frontend(img, taps14, (MN, MX))
        nm = kfe.frontend(img, taps14)
        kern = gaussian_kernel(SIGMA)
        _, rounds = P.hysteresis_packed_masks(weak, strong, h, w)
        t = {
            "k1_ms": time_ms(lambda: kfe.frontend(img, taps14, (MN, MX)), 50),
            "k1_nm_ms": time_ms(lambda: kfe.frontend(img, taps14), 50),
            "k2_ms": time_ms(lambda: khp.hysteresis_packed(weak, strong, h, w),
                             50),
            # empty masks: one step that floods nothing, the kernel's floor
            "k2_empty_ms": time_ms(lambda: khp.hysteresis_packed(
                torch.zeros_like(weak), torch.zeros_like(weak), h, w), 50),
            "frame_ms": time_ms(lambda: model(img, MN, MX), 20),
            "frame_packed_ms": time_ms(lambda: model.packed(img, MN, MX), 20),
            "k1_plain_ms": time_ms(
                lambda: Wn.frontend_nm(img, kern, (MN, MX)), 3, 3),
            "k2_plain_ms": time_ms(
                lambda: P.hysteresis_packed_masks(weak, strong, h, w), 3, 3),
            "k2_nm_int16_plain_ms": time_ms(
                lambda: P.hysteresis_packed(nm, MN, MX), 3, 3),
            "frame_plain_ms": time_ms(
                lambda: P.unpack_edges(plain_packed(img, False), w), 3, 3),
            "k2_plain_rounds": rounds,
        }
        for key, fn in (
                ("k1", lambda: kfe.frontend(img, taps14, (MN, MX))),
                ("k2", lambda: khp.hysteresis_packed(weak, strong, h, w)),
                ("k2_nm_int16", lambda: khp.hysteresis_packed_nm(nm, MN, MX)),
                ("frame", lambda: model(img, MN, MX)),
                ("frame_impl_packed", lambda: canny_fused(
                    img, MN, MX, kernel_vals=taps14))):
            t[f"{key}_host_ms"] = host_ms(fn)
        for key, fn in (
                ("k2_int16", lambda: khp.hysteresis_packed(
                    weak, strong, h, w, edges_int16=True)),
                ("k2_nm_int16", lambda: khp.hysteresis_packed_nm(nm, MN, MX)),
                ("k2_nm_packed", lambda: khp.hysteresis_packed_nm(
                    nm, MN, MX, packed_out=True))):
            t[f"{key}_ms"] = time_ms(fn, 50)
        _, steps = khp.hysteresis_packed(weak, strong, h, w, return_steps=True)
        t["k2_steps"] = int(steps)
        wd = -(-w // 32)
        window = len(kern)
        # K1: each input byte read once, the two packed masks written once;
        # per pixel 2 passes x (window mul + window add) + 2 divides + floor,
        # ~14 Sobel, ~10 magnitude, ~16 NMS and 2 threshold operations
        k1_bytes = h * w + 2 * h * wd * 4
        k1_ops = h * w * (4 * window + 45)
        # K2: two masks read, one written; one dilation + row and column
        # flood over every word (~40 operations a word) is the least work
        k2_bytes = 3 * h * wd * 4
        k2_ops = 40 * h * wd
        # K2 from an NMS map to int16 edges: 2 + 2 bytes a pixel, and two
        # compares and a select a pixel more
        k2n_bytes = 4 * h * w
        k2n_ops = k2_ops + 3 * h * w
        for k, b, o in (("k1", k1_bytes, k1_ops), ("k2", k2_bytes, k2_ops),
                        ("k2_nm_int16", k2n_bytes, k2n_ops)):
            tb, to = b / HBM_BYTES_PER_S * 1e3, o / SEPARATE_OPS_PER_S * 1e3
            t[f"{k}_bound_ms"] = max(tb, to)
            t[f"{k}_bound_by"] = "bytes" if tb >= to else "operations"
        times[name] = t
        log(f"times {name}: {t}")
    _, (sw, ss), h, w = flood_cases["snake_1080p"][:4]
    _, steps = khp.hysteresis_packed(sw, ss, h, w, return_steps=True)
    times["snake_1080p"] = {
        "k2_ms": time_ms(lambda: khp.hysteresis_packed(sw, ss, h, w), 3, 3),
        "k2_steps": int(steps)}
    log(f"times snake: {times['snake_1080p']}")
    report["times"] = times
    report["times_6_s"] = time.perf_counter() - t0

    # ---- 7. K3 and K4 against their plain versions ----
    t0 = time.perf_counter()
    nm_cases = {}
    for name, (h, w) in SIZES.items():
        nm = kfe.frontend(torch.from_numpy(make_image(h, w)).to(dev), taps14)
        nm_cases[f"k1_nm_{name}"] = (nm, [(MN, MX), (0, 40)])
    nm_cases["random_1080p"] = (random_nm(rng, 1080, 1920), [(MN, MX)])
    for h, w in ((257, 333), (64, 33), (1, 1000), (40, 1)):
        nm_cases[f"random_{h}x{w}"] = (random_nm(rng, h, w), [(MN, MX), (0, 40)])
    for w in (1000, 1921, 3840, 7680, 9000):   # K4: words a lane, block path
        nm_cases[f"sparse_150x{w}"] = (sparse_nm(rng, 150, w), [(10, 100)])
    alt_tile, alt_band = (32, 100), 16
    engine_sweeps = {}
    engine_err = {"dilate": 0, "banded": 0}
    phase7_s = {}                # seconds by group of cases, plain versions
    for name, (nm, pairs) in nm_cases.items():
        t_case = time.perf_counter()
        nm = torch.as_tensor(nm).to(dev)
        full = name.startswith("k1_nm_4k")   # the plain mirrors are slow there
        one_tile = full or name.startswith("sparse")
        for mn, mx in pairs:
            runs = [("dilate", {"tile": t}) for t in
                    ([Dl.DEFAULT_TILE] if one_tile
                     else [Dl.DEFAULT_TILE, alt_tile])]
            # (the default band of a 150-row image is the image, which at
            # these widths is halved to fit the card: an explicit band there)
            runs += [("banded", {"band_h": b}) for b in
                     ([None] if full else [64, alt_band]
                      if name.startswith("sparse") else [None, alt_band])]
            for engine, kw in runs:
                kern, plain = ((k3.hysteresis_dilate, Dl.hysteresis_dilate)
                               if engine == "dilate" else
                               (k4.hysteresis_banded, Bd.hysteresis_banded))
                out, sweeps = kern(nm, mn, mx, return_sweeps=True, **kw)
                sync()
                ref, ref_sweeps = plain(nm, mn, mx, return_sweeps=True, **kw)
                engine_err[engine] = max(engine_err[engine], int(
                    (out.to(torch.int32) - ref).abs().max()))
                check(torch.equal(out, ref) and sweeps == ref_sweeps,
                      f"{engine} differs: {name} {mn}/{mx} {kw} "
                      f"(sweeps {sweeps} vs {ref_sweeps})")
                engine_sweeps[f"{engine}/{name}/{mn}-{mx}/{kw}"] = sweeps
        group = name.split("_")[0]
        phase7_s[group] = phase7_s.get(group, 0.0) + time.perf_counter() - t_case
    t_case = time.perf_counter()
    chains = {"snake_1080p": torch.from_numpy(snake_nm(1080, 1920)).to(dev),
              "spiral_40": torch.from_numpy(spiral_nm()).to(dev)}
    for name, nm in chains.items():
        h, w = nm.shape
        ref = P.unpack_edges(khp.hysteresis_packed(
            P.pack_mask(nm >= 10), P.pack_mask(nm >= 100), h, w), w)
        check(int((ref == 255).sum()) == int((nm >= 10).sum()),
              f"{name}: K2 did not light the whole chain")
        for engine, kern, kws in (
                ("dilate", k3.hysteresis_dilate, [{}, {"tile": alt_tile}]),
                ("banded", k4.hysteresis_banded, [{}, {"band_h": alt_band}])):
            for kw in kws:
                out, sweeps = kern(nm, 10, 100, return_sweeps=True, **kw)
                sync()
                check(torch.equal(out, ref), f"{engine} differs from K2: "
                      f"{name} {kw}")
                engine_sweeps[f"{engine}/{name}/{kw}"] = sweeps
    phase7_s["chains"] = time.perf_counter() - t_case
    t_case = time.perf_counter()
    # 100 calls back to back on one frame: tokens and flags never cleared
    nm, _ = nm_cases["k1_nm_1080p"]
    for engine, kern, plain in (
            ("dilate", k3.hysteresis_dilate, Dl.hysteresis_dilate),
            ("banded", k4.hysteresis_banded, Bd.hysteresis_banded)):
        outs = [kern(nm, MN, MX) for _ in range(100)]
        sync()
        ref = plain(nm, MN, MX)
        check(all(torch.equal(o, ref) for o in outs),
              f"{engine}: a call of 100 back to back differs")
    phase7_s["100_calls"] = time.perf_counter() - t_case
    report["k3_k4_check"] = {"sweeps": engine_sweeps, "s_by_group": phase7_s,
                             "s": time.perf_counter() - t0}
    log(f"K3/K4 bit-equal to their plain versions and K2: {engine_sweeps}")

    # ---- 8. the pallas path: launch counts from 0 ----
    t0 = time.perf_counter()
    mods = {"frontend": kfe, "hysteresis_packed": khp,
            "hysteresis_dilate": k3, "hysteresis_banded": k4}
    for m in mods.values():
        m.launches = 0

    def launch_counts():
        return {k: m.launches for k, m in mods.items()}

    pallas_models = {b: CannyTorch(SIGMA, backend=b) for b in ("pallas", "xla")}
    strict_pallas = CannyTorch(SIGMA, hysteresis_mode="strict-reference",
                               backend="pallas")
    imgs = {name: torch.from_numpy(fr[0]).to(dev) for name, fr in frames.items()}
    pouts, per_run, plain_by_run = {}, {}, {}
    for run in [*IMPLS, "model/pallas", "model/xla", "model/pallas-strict"]:
        before = launch_counts()
        plain_calls = dict(P.calls)
        for name, img in imgs.items():
            if run in IMPLS:
                pouts[run, name] = canny_fused(img, MN, MX, kernel_vals=taps14,
                                               hysteresis_impl=run)
            elif run == "model/pallas-strict":
                pouts[run, name] = strict_pallas(img, MN, MX)
            else:
                model = pallas_models[run.split("/")[1]]
                pouts[run, name] = model(img, MN, MX)
                pouts[run + "/batch", name] = model.batch(np.stack(
                    frames[name][:2]), MN, MX)
        per_run[run] = {k: v - before[k] for k, v in launch_counts().items()}
        plain_by_run[run] = sum(P.calls.values()) - sum(plain_calls.values())
    sync()
    pallas_counts = launch_counts()
    log(f"pallas path launches: {pallas_counts} by run {per_run}")
    uses = {"packed": {"frontend", "hysteresis_packed"},
            "packed-xla": {"frontend"},
            "banded": {"frontend", "hysteresis_banded"},
            "dilate": {"frontend", "hysteresis_dilate"},
            "model/pallas": {"frontend", "hysteresis_packed"},
            "model/pallas-strict": {"frontend", "hysteresis_packed"},
            "model/xla": set()}
    for run, c in per_run.items():
        check(all((c[k] > 0) == (k in uses[run]) for k in c),
              f"{run} launched {c}, expected exactly {sorted(uses[run])}")
    check(all(v > 0 for v in pallas_counts.values()),
          f"a kernel of the pallas path was not launched: {pallas_counts}")
    # only the two plain engines (the oracles) may pack or unpack in PyTorch
    for run, n in plain_by_run.items():
        check((n > 0) == (run in ("packed-xla", "model/xla")),
              f"{run} called the plain pack/unpack {n} times")

    def profile_kernels(fn, reps=5, tries=3):
        """``{kernel name: (launches, device ms)}`` per call of ``fn``
        (torch.profiler, ``reps`` calls a window); {} where the profiler
        records no device time in any of ``tries`` windows.  A window can
        lose a record, as a rule its first: the launches are those recorded
        over ``reps``, so a lost one shows as a fraction, and the time is the
        mean over the launches recorded times the launches a call."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        by = {}
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                sync()
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", 0) or 0
                if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
                    per_call = max(1, round(e.count / reps))
                    by[e.key[:48]] = (e.count / reps,
                                      us / 1e3 / e.count * per_call)
            if by:
                break
        return by

    # a `banded` or `dilate` frame: K1 and the engine, nothing else on the
    # device, and no wait for the device inside the call: 20 frames queued
    # behind ~3 ms of serpentine return long before the device has finished
    long_nm = torch.from_numpy(snake_nm(1080, 1920)).to(dev)
    engine_frames = {}
    for impl in ("banded", "dilate"):
        img = imgs["1080p"]

        def frame():
            return canny_fused(img, MN, MX, kernel_vals=taps14,
                               hysteresis_impl=impl)

        # eight frames a window: two kernel names, each launched once a
        # frame.  A window can lose records (n < 1 then, and up to three
        # windows are merged until two names are seen); a third kernel would
        # be a third name, a second launch of one n >= 1.5
        by = {}
        for _ in range(3):
            for k, (n, _) in profile_kernels(frame, reps=8).items():
                by[k] = max(n, by.get(k, 0))
            if len(by) >= 2:
                break
        check(len(by) == 2 and all(0 < n <= 1 for n in by.values()),
              f"a {impl} frame is not two kernels on the device: {by}")
        sync()
        t_a = time.perf_counter()
        k3.hysteresis_dilate(long_nm, 10, 100)
        for _ in range(20):
            frame()
        t_b = time.perf_counter()
        sync()
        t_c = time.perf_counter()
        check(t_b - t_a < 0.5 * (t_c - t_a),
              f"{impl} frames wait for the device: enqueued in "
              f"{(t_b - t_a) * 1e3:.3f} ms of {(t_c - t_a) * 1e3:.3f}")
        engine_frames[impl] = {"kernels_a_frame": by,
                               "enqueue_21_calls_ms": (t_b - t_a) * 1e3,
                               "device_done_ms": (t_c - t_a) * 1e3}
    log(f"engine frames: {engine_frames}")

    def plain_edges(img, strict=False):
        return P.hysteresis_packed(Wn.frontend_nm(img, gaussian_kernel(SIGMA)),
                                   MN, MX, strict=strict)

    for name, img in imgs.items():
        ref = plain_edges(img)
        ref_strict = plain_edges(img, strict=True)
        for (run, nm_), got in pouts.items():
            if nm_ != name:
                continue
            want = ref_strict if run == "model/pallas-strict" else ref
            if run.endswith("/batch"):
                want = torch.stack([plain_edges(torch.from_numpy(f).to(dev))
                                    for f in frames[name][:2]])
            check(got.dtype == torch.int16 and torch.equal(got, want),
                  f"pallas path differs from the plain pipeline: {run} {name}")
    for b, model in pallas_models.items():
        cpu = CannyTorch(SIGMA, device="cpu", backend=b)
        check(torch.equal(model(small, MN, MX).cpu(), cpu(small, MN, MX)),
              f"card and CPU differ on 256x256: backend {b}")
    cpu_ref = CannyTorch(SIGMA, device="cpu")(small, MN, MX)
    for impl in IMPLS:
        got = canny_fused(torch.from_numpy(small).to(dev), MN, MX,
                          kernel_vals=taps14, hysteresis_impl=impl)
        check(torch.equal(got.cpu(), cpu_ref),
              f"card and CPU differ on 256x256: {impl}")
    report["pallas_path"] = {"launches": pallas_counts, "by_run": per_run,
                             "plain_pack_unpack_calls": plain_by_run,
                             "engine_frames": engine_frames,
                             "s": time.perf_counter() - t0}
    log("pallas path bit-equal to the plain pipeline")

    # ---- 9. times of K3, K4 and the pallas path ----
    t0 = time.perf_counter()

    def device_ms(fn):
        """Device time per call by kernel name; {} if none was recorded."""
        return {k: ms for k, (_, ms) in profile_kernels(fn).items()}

    for name, (h, w) in SIZES.items():
        img = imgs[name]
        nm = kfe.frontend(img, taps14)
        t = times[name]
        # device time against the wall times of phase 6: what the host costs
        weak, strong = kfe.frontend(img, taps14, (MN, MX))
        for key, fn in (
                ("k1", lambda: kfe.frontend(img, taps14, (MN, MX))),
                ("k2", lambda: khp.hysteresis_packed(weak, strong, h, w)),
                ("k2_empty", lambda: khp.hysteresis_packed(
                    torch.zeros_like(weak), torch.zeros_like(weak), h, w)),
                ("k2_nm_int16", lambda: khp.hysteresis_packed_nm(nm, MN, MX)),
                ("frame", lambda: models["component"](img, MN, MX)),
                ("frame_impl_packed", lambda: canny_fused(
                    img, MN, MX, kernel_vals=taps14))):
            by = device_ms(fn)
            t[f"{key}_device_ms"] = sum(by.values()) if by else "not measured"
            t[f"{key}_device_by_kernel"] = by
        _, st3 = k3.dilate_stats(nm, MN, MX)
        _, st4 = k4.banded_stats(nm, MN, MX)
        t["k3_sweeps"], t["k4_sweeps"] = st3["sweeps"], st4["sweeps"]
        t["k3_tile_floods"] = st3["tile_floods"]
        t["k3_flood_rounds_mean"] = st3["flood_rounds"] / st3["tile_floods"]
        t["k4_rounds_max"] = st4["rounds_max"]
        t["k4_rounds_mean"] = st4["rounds_sum"] / st4["bands_run"]
        for k, fn in (("k3", k3.hysteresis_dilate), ("k4", k4.hysteresis_banded)):
            t[f"{k}_ms"] = time_ms(lambda: fn(nm, MN, MX), 20)
            t[f"{k}_host_ms"] = host_ms(lambda: fn(nm, MN, MX))
            by = device_ms(lambda: fn(nm, MN, MX))
            t[f"{k}_device_ms"] = sum(by.values()) if by else "not measured"
            t[f"{k}_device_by_kernel"] = by
        t["k3_plain_ms"] = time_ms(lambda: Dl.hysteresis_dilate(nm, MN, MX), 1, 1)
        t["k4_plain_ms"] = time_ms(lambda: Bd.hysteresis_banded(nm, MN, MX), 1, 1)
        for impl in IMPLS:
            t[f"frame_impl_{impl}_ms"] = time_ms(lambda: canny_fused(
                img, MN, MX, kernel_vals=taps14, hysteresis_impl=impl), 10, 3)
        for b, model in pallas_models.items():
            t[f"frame_model_{b}_ms"] = time_ms(lambda: model(img, MN, MX), 10, 3)
        # K3 and K4: nm read once (2 B/px), int16 edges written once
        # (2 B/px); per pixel two compares and one select, per packed word
        # one dilation and row/column flood (~40 operations)
        eng_bytes = 4 * h * w
        eng_ops = 3 * h * w + 40 * h * (-(-w // 32))
        tb, to = eng_bytes / HBM_BYTES_PER_S * 1e3, eng_ops / SEPARATE_OPS_PER_S * 1e3
        for k in ("k3", "k4"):
            t[f"{k}_bound_ms"] = max(tb, to)
            t[f"{k}_bound_by"] = "bytes" if tb >= to else "operations"
        log(f"times {name}: {t}")
    sn = chains["snake_1080p"]
    times["snake_1080p"]["k2_nm_int16_ms"] = time_ms(
        lambda: khp.hysteresis_packed_nm(sn, 10, 100), 3, 3)
    for k, kern in (("k3", k3.hysteresis_dilate), ("k4", k4.hysteresis_banded)):
        _, sweeps = kern(sn, 10, 100, return_sweeps=True)
        times["snake_1080p"][f"{k}_ms"] = time_ms(lambda: kern(sn, 10, 100), 3, 3)
        times["snake_1080p"][f"{k}_sweeps"] = sweeps
    _, st3 = k3.dilate_stats(sn, 10, 100)
    _, st4 = k4.banded_stats(sn, 10, 100)
    times["snake_1080p"].update(
        k3_tile_floods=st3["tile_floods"], k4_rounds_max=st4["rounds_max"],
        k4_rounds_mean=st4["rounds_sum"] / st4["bands_run"])
    log(f"times snake: {times['snake_1080p']}")
    # A frame whose default band (the whole image below 512 rows) exceeds a
    # block's shared memory runs with a halved band.  Two footprints above
    # 48 KB in turn on one kernel: the larger still launches after the
    # smaller has run (bands of 250 and 200 rows; tiles of 102 and 80 KB).
    turns = []
    for h in (500, 400):
        nm = torch.from_numpy(random_nm(rng, h, 1920)).to(dev)
        turns.append((k4.hysteresis_banded, nm, {},
                      Bd.hysteresis_banded(nm, MN, MX)))
    nm = torch.from_numpy(random_nm(rng, 600, 2048)).to(dev)
    for tile in ((256, 1024), (200, 1024)):
        turns.append((k3.hysteresis_dilate, nm, {"tile": tile},
                      Dl.hysteresis_dilate(nm, MN, MX, tile=tile)))
    for _ in range(3):
        for kern, nm, kw, ref in turns:
            check(torch.equal(kern(nm, MN, MX, **kw), ref),
                  f"{kern.__name__} differs on {tuple(nm.shape)} {kw} with "
                  f"footprints alternating")
    report["times_s"] = time.perf_counter() - t0

    # ---- 10. the command-line path ----
    t0 = time.perf_counter()
    report["cli_path"] = command_line_phase(dev, time_ms)
    report["cli_path"]["s"] = time.perf_counter() - t0

    # ---- 11. the multi-device path ----
    t0 = time.perf_counter()
    md = multi_device_phase(dev, time_ms, device_ms)
    md["s"] = time.perf_counter() - t0
    report["multi_device"] = md
    md_line = {"card": card, "launches": md["sharded_check"]["launches"],
               "rounds_per_frame": md["sharded_check"]["rounds_per_frame"],
               "sharded_4k": {k: {"wall_ms": v["wall_ms"],
                                  "device_ms": v["device_ms"]}
                              for k, v in md["sharded_4k_times"].items()
                              if isinstance(v, dict)},
               "fused_frame_4k_ms": md["sharded_4k_times"]["fused_frame_4k_ms"]}
    print("multi-device: " + json.dumps(md_line), flush=True)

    t1 = times["1080p"]
    kernels = [
        {"name": "frontend", "route": "cuda",
         "source": "canny_edge_tpu_torch/kernels/csrc/frontend.cu",
         "replaces": "canny_edge_tpu/kernels/frontend.py:153",
         "launches": counts["frontend"], "max_abs_err": k1_err,
         "ms": t1["k1_ms"], "plain_ms": t1["k1_plain_ms"],
         "bound_ms": t1["k1_bound_ms"], "bound_by": t1["k1_bound_by"],
         "library_ms": None, "match": True, "shape": "1080x1920",
         "ms_4k": times["4k"]["k1_ms"]},
        {"name": "hysteresis_packed", "route": "cuda",
         "source": "canny_edge_tpu_torch/kernels/csrc/hysteresis_packed.cu",
         "replaces": "canny_edge_tpu/kernels/hysteresis_packed.py:180",
         "launches": counts["hysteresis_packed"], "max_abs_err": k2_err,
         "ms": t1["k2_ms"], "plain_ms": t1["k2_plain_ms"],
         "bound_ms": t1["k2_bound_ms"], "bound_by": t1["k2_bound_by"],
         "library_ms": None, "match": True, "shape": "1080x1920",
         "steps": t1["k2_steps"], "ms_4k": times["4k"]["k2_ms"],
         "nm_int16_ms": t1["k2_nm_int16_ms"],
         "nm_int16_plain_ms": t1["k2_nm_int16_plain_ms"],
         "nm_int16_bound_ms": t1["k2_nm_int16_bound_ms"],
         "nm_int16_bound_by": t1["k2_nm_int16_bound_by"],
         "nm_int16_ms_4k": times["4k"]["k2_nm_int16_ms"]},
    ]
    for k, name, src, line in (
            ("k3", "hysteresis_dilate", "hysteresis_dilate.cu",
             "canny_edge_tpu/kernels/hysteresis.py:41"),
            ("k4", "hysteresis_banded", "hysteresis_banded.cu",
             "canny_edge_tpu/kernels/hysteresis_v2.py:70")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"canny_edge_tpu_torch/kernels/csrc/{src}",
            "replaces": line, "launches": pallas_counts[name],
            "max_abs_err": engine_err[name.split("_")[1]],
            "ms": t1[f"{k}_ms"], "plain_ms": t1[f"{k}_plain_ms"],
            "bound_ms": t1[f"{k}_bound_ms"], "bound_by": t1[f"{k}_bound_by"],
            "library_ms": None, "match": True, "shape": "1080x1920",
            "sweeps": t1[f"{k}_sweeps"], "ms_4k": times["4k"][f"{k}_ms"],
            "plain_ms_4k": times["4k"][f"{k}_plain_ms"],
            "device_ms": t1[f"{k}_device_ms"], "host_ms": t1[f"{k}_host_ms"],
            "device_ms_4k": times["4k"][f"{k}_device_ms"]})
    kernels[-1]["rounds"] = {"max": t1["k4_rounds_max"],
                             "mean": t1["k4_rounds_mean"]}
    kt = md["kernel_times"]
    kernels += [
        {"name": "frontend_block", "route": "cuda",
         "source": "canny_edge_tpu_torch/kernels/csrc/frontend.cu",
         "replaces": "canny_edge_tpu/kernels/frontend.py:153",
         "launches": md["sharded_check"]["launches"]["frontend_block"],
         "max_abs_err": md["max_abs_err"]["frontend_block"],
         "ms": kt["k1_block_ms"], "plain_ms": kt["k1_block_plain_ms"],
         "bound_ms": kt["k1_block_bound_ms"],
         "bound_by": kt["k1_block_bound_by"], "library_ms": None,
         "match": True, "shape": "a 1080x960 block of 2160x3840, halo 7",
         "device_ms": kt["k1_block_device_ms"]},
        {"name": "hysteresis_packed_quirk", "route": "cuda",
         "source": "canny_edge_tpu_torch/kernels/csrc/hysteresis_packed.cu",
         "replaces": "canny_edge_tpu/kernels/hysteresis_packed.py:180",
         "launches": md["sharded_check"]["launches"]["hysteresis_packed_quirk"],
         "max_abs_err": md["max_abs_err"]["k2_quirk"],
         "ms": kt["k2_quirk_ms"], "plain_ms": kt["k2_quirk_plain_ms"],
         "bound_ms": kt["k2_quirk_bound_ms"],
         "bound_by": kt["k2_quirk_bound_by"], "library_ms": None,
         "match": True, "shape": "1082x1024 (a 4K block with its halo), "
                                 "strict, quirk (1, 1)",
         "device_ms": kt["k2_quirk_device_ms"], "steps": kt["k2_quirk_steps"]},
    ]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_run
    log("report: " + json.dumps(report))
    out_dir = os.path.join(ROOT, "chiprun_out")     # listed in .gitignore
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # report any phase's failure and exit non-zero
        traceback.print_exc()
        sys.exit(1)
