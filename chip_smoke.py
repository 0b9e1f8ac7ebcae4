"""Smoke test of the PyTorch/CUDA port on one GPU: builds, checks and times
the kernels of both ported paths: ``CannyTorch``'s ``fused`` backend (K1
front end -> K2 packed flood -> unpack) and the ``pallas`` backend
(``canny_fused``: K1 in NMS mode -> K2, K3 tiled dilation or K4 banded
raster scan); then drives the command line (frames in, batched and staged
onto the card, K1 -> K2 a frame, PNGs out), the stage path and
``SobelTorch`` on the card, the multi-device path (``ShardedCanny``: K1 in
block mode -> the distributed K2 flood) over meshes on the one card,
the port's headline bench (``bench_torch.py``: ``canny_fn``'s three
backends at 1080p, with the roofline of their stages), the batch path, a
seeded sweep of every kernel mode over random geometry (phase 14), K1
and K4 past their former limits (phase 15: windows above 263 taps, rows
wider than 32768 columns), and uint16 frames on the ``fused`` path (phase
16: a 10980x10980 tile, a Sentinel-2 L1C band's size).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ``canny_edge_tpu_torch/kernels/csrc`` (nvcc)
     and the native feeder from ``canny_edge_tpu_torch/runtime/csrc`` (g++);
  3. K1 against its plain PyTorch version on the card, bit-equal, in nm and
     threshold mode (8 sigmas: windows 3 to 15 and 19, all on the tile path;
     1080p and 4K, shapes one off its 64x64 tile, W = 1,
     31, 33, 333, 1000, 1921; 3 threshold pairs, and one far outside the
     magnitudes);
  4. K2 against its plain versions, bit-equal, component and strict, in all
     four modes (packed masks or NMS map in, packed mask or int16 out): K1's
     maps at 1080p and 4K, a serpentine chain, a spiral, random maps and
     masks, ragged shapes; its step count held against the plain mirror of
     its tile schedule (at most the mirror's);
  5. the full ``CannyTorch`` path at 1080p and 4K (sigma 1.4, 30/90):
     ``__call__``, ``packed`` and ``batch_packed`` (B=4) in both modes, with
     every launch count set to 0 just before and read just after (exactly
     one launch of K1 and of K2 a call, the batch included) and no plain
     pack or unpack called, then held against the plain pipeline on the
     card; plus the card against the CPU on a small frame;
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
     reader, equals ``CannyTorch``'s edges and each kernel ran once a batch;
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
     flood's rounds a frame, printed on a ``multi-device:`` line;
 12. the port's headline bench (``bench_torch.measure``, 3 samples a
     backend): MP/s of the ``fused``, ``pallas`` and ``xla`` backends at
     1080p by the checksum slope, their device time, and the roofline of
     each backend's two stages against its audited floor
     (``utils/opcount.py``, ``utils/roofline.py``), checked for a plausible
     share and a front-end audit of 50 to 400 operations a pixel; every
     bound of the ``kernels`` line held equal to
     ``utils.roofline.kernel_bounds``; printed on a ``bench:`` line;
 13. the batch path (JAX's ``vmap`` over its kernels): K1 in both modes,
     K2 in its four modes (component and strict), K3 and K4 on ``(B, H,
     W)`` batches, one launch each, held bit-equal to B single-frame
     launches and to the plain versions frame by frame, K3's and K4's sweeps
     equal to the most of a frame: 8 1080p and 2 4K frames, a mixed batch
     (an empty map, the serpentine, a random map) and batches of 3 at
     257x333, 1x1000, 40x1 and 64x33 (unaligned frame starts); the main
     path's launch counts from 0 (exactly one launch of each stage a batch
     for ``fused`` ``batch`` / ``batch_packed``, ``pallas`` and
     ``canny_fused`` with each engine); a batch's wall, host enqueue and
     device time beside its frames one by one, printed on a ``batch:``
     line; the batch rows' bounds held equal to ``kernel_bounds(batch=B)``;
 14. the seeded sweep (``sweep_configs``: 24 drawn frame configurations,
     the JAX package's fuzz configurations and degenerate shapes, and its
     13 sharded ones): K1 in NMS, threshold and batch mode, K2's modes with
     the strict fix at a random (row, word), K3 and K4 on K1's maps and
     random, serpentine and sparse ones, each against its plain version
     (K2 also against its tile mirror, K4 at the band that ran), the entry
     points of each backend against the CPU and ``golden``, ``ShardedCanny``
     (K1 block mode, K2's quirk, the generic engine) against the fused
     backend and ``golden``, and K1 on 65537 frames; then, appended, a
     sigma-0.1 configuration against ``golden`` and the threshold cases
     (``THRESHOLD_CONFIGS``, 9 frame and 2 sharded configurations, with
     fractional, float32-rounded, NumPy float32, 0-d CUDA tensor, NaN and
     +-inf thresholds: K1's threshold mode, K2's NMS-map entry, K3 and K4
     against their plain versions, the functional entry points against the
     CPU and ``golden``, the model classes, which truncate, against the
     CPU); printed on a ``sweep:`` line (cases by kernel and mode,
     launches, threshold cases, mismatches, seconds);
 15. capacity (``capacity_phase``): K1 at windows 263, 265, 301 and 601
     (its ring path on the H100, which takes 105 to 613 taps) and 701 (its
     scratch path) and K4 at 32768, 32769, 40000, 131072 and 524288 columns.
     The slice's path with its launch counts from 0 (``CannyTorch``
     ``fused``, ``canny_fn`` ``pallas`` and ``ShardedCanny`` static on an
     in-process 1x2x2 mesh at each window on a 1080p ``capacity_frame``,
     ``canny_fused`` ``banded`` on a 96x40000 frame: K1's ring and scratch
     paths in frame and block mode and K4's wide path run) against the
     plain pipeline; K1 in NMS, threshold, batch (3 at 257x333) and block
     mode and K4 (a serpentine and a random map, edges and sweeps at the
     band that ran) against their plain versions, ``canny_fn`` against
     ``golden``; K1 in threshold mode over the window sweep ``K1_SWEEP``
     (17 to 601 taps) against its plain version, with its path, device ms
     and bound at each window; 0 mismatches; device ms by window and width,
     printed on a ``capacity:`` line.
 16. uint16 (``uint16_phase``): a 10980x10980 uint16 tile (a Sentinel-2
     L1C 10 m band tile's size) at white levels 10000 and 65535 through
     ``CannyTorch``'s ``fused`` path, with K1's and K2's launch counts and
     ``u16_frames`` from 0 (one launch of each, one uint16 frame, one
     plan), bit-equal to the plain PyTorch pipeline of
     ``portbench/reference/plain_torch.py`` on the card, and K1's masks to
     its NMS map; K1's uint16 time by CUDA events and torch.profiler beside
     its bound (``frontend_u16`` on the kernels line), printed on a
     ``uint16:`` line.
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

from bench_torch import make_image  # noqa: E402  (the headline frame)

SIGMA, MN, MX = 1.4, 30, 90
SIZES = {"1080p": (1080, 1920), "4k": (2160, 3840)}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


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


# ---------------------------------------------------------------------------
# the seeded sweep (phase 14; tests/test_torch_sweep.py imports it)
# ---------------------------------------------------------------------------

SWEEP_SEED = 20261017
SWEEP_SIGMAS = (0.3, 0.5, 0.75, 1.0, 1.4, 2.0, 2.5, 3.0, 4.9, 6.0)
FORCED_THRESHOLDS = ((0, 1), (0, 255), (254, 255))
# Sizes near which a kernel's geometry changes, by axis: 16 (K1's 16-byte
# loads), 32 (a packed word), K1's 64x64 tile, K2's tile of 8 rows x 32
# words (1024 columns), K3's 128x512 tile, K4's default band (64 rows from
# 512 rows on, the whole image below) and its words a lane (1024 columns).
ROW_EDGES = (8, 16, 32, 64, 128, 512)
COL_EDGES = (16, 32, 64, 512, 1024)
# every factorization of 8 devices into (data, y, x)
MESHES = ((1, 1, 8), (1, 8, 1), (1, 2, 4), (1, 4, 2), (2, 2, 2),
          (2, 1, 4), (2, 4, 1), (4, 2, 1), (4, 1, 2), (8, 1, 1))


# Phase 14's threshold cases, appended to the draws (which stay as they
# are): these frame and sharded configurations also run every kind of
# threshold pair of :func:`threshold_pair` around their integers
THRESHOLD_CONFIGS = ("sweep3", "sweep5", "sweep6", "sweep14", "sweep19",
                     "sweep22", "fuzz0", "fuzz8", "sigma0.1", "sharded10",
                     "sharded11")
PAIR_KINDS = ("half", "eps", "float32", "tensor", "nan", "inf", "-inf",
              "-inf-nan")
MODEL_KINDS = PAIR_KINDS[:4]      # the model classes take [0, 255] only


def threshold_pair(kind, mn, mx, device="cpu"):
    """The thresholds a caller passes, of ``kind``, around the integers
    ``mn`` and ``mx`` (``mx`` <= 254): fractions (``half``), values that
    float32 rounds to the integers (``eps``), NumPy float32 scalars, 0-d
    float32 tensors on ``device``, and NaN, +inf and -inf.  The model
    classes truncate the first four to ``(mn, mx)``; everything else
    compares them as JAX does (:func:`golden_pair`)."""
    nan, inf = float("nan"), float("inf")
    if kind == "tensor":
        import torch

        return tuple(torch.tensor(t, dtype=torch.float32, device=device)
                     for t in (mn + 0.5, mx + 0.25))
    return {"half": (mn + 0.5, mx + 0.25), "eps": (mn + 1e-8, mx + 1e-8),
            "float32": (np.float32(mn + 0.5), np.float32(mx + 0.5)),
            "nan": (nan, mx + 0.5), "inf": (mn + 0.5, inf),
            "-inf": (-inf, mx), "-inf-nan": (-inf, nan)}[kind]


def golden_pair(kind, mn, mx):
    """:func:`threshold_pair` as ``golden`` takes it: each float as the
    float32 that JAX compares with (``golden`` compares in float64)."""
    return tuple(float(np.float32(t)) for t in threshold_pair(kind, mn, mx))


def _sweep_size(rng, hi, edges):
    """1 .. ``hi``: half the draws within +-2 of a multiple of an edge."""
    if rng.random() < 0.5:
        return int(rng.integers(1, hi + 1))
    unit = int(rng.choice([e for e in edges if e <= hi] or [1]))
    k = int(rng.integers(1, hi // unit + 1))
    return int(np.clip(k * unit + int(rng.integers(-2, 3)), 1, hi))


def _quirk(rng, h, w):
    """A (row, word) with a row below it and the word's pixels 0 to 2 in
    the image, where the image has them (:func:`plant_quirk`)."""
    return (int(rng.integers(0, max(h - 1, 1))),
            int(rng.integers(0, max(-(-(w - 2) // 32), 1))))


def plant_quirk(weak, strong, quirk_rw):
    """Bool ``(h, w)`` masks with the strict fix's case planted at
    ``quirk_rw`` = (r, word), c = 32 word: (r + 1, c) strong, (r, c + 1)
    weak and not strong, and every other neighbour of (r, c + 1) not weak,
    so that (r, c + 1) is an edge in component mode and not in strict mode
    with the fix at ``quirk_rw``.  Unchanged where the image is smaller
    than 2 x 3 pixels."""
    r, c = quirk_rw[0], 32 * quirk_rw[1]
    h, w = weak.shape
    weak, strong = weak.clone(), strong.clone()
    if r + 1 < h and c + 2 < w:
        weak[max(r - 1, 0):r + 2, c:c + 3] = False
        weak[r, c + 1] = weak[r + 1, c] = True
        strong[r + 1, c] = True
        strong[r, c + 1] = False
    return weak, strong & weak


def sweep_configs(seed=SWEEP_SEED, n=24, max_hw=(1200, 2100)):
    """The sweep, deterministic in its arguments: ``{"frames": [...],
    "sharded": [...]}``.

    ``frames``: ``n`` configurations drawn from ``seed`` (H in 1 ..
    ``max_hw[0]``, W in 1 .. ``max_hw[1]``, half of each near an edge of
    ``ROW_EDGES`` / ``COL_EDGES``; sigma from ``SWEEP_SIGMAS``; thresholds
    ``mn`` 0-80 and ``mx = mn + 1-120`` capped at 255, and every eighth
    from the third on one of ``FORCED_THRESHOLDS``; component and strict in
    turns; B from {1, 2, 3, 5}; a frame of noise or the headline scene; a
    quirk ``(row, word)`` inside the masks (:func:`_quirk`); every fourth
    also an NMS map: ``random``, ``snake`` or ``sparse``), then the JAX
    package's fuzz:
    ``tests/test_fuzz_bitexact.py``'s ten configurations (seed 20260817)
    and its six degenerate shapes, each with JAX's frame.  Each is a dict
    with ``name, h, w, sigma, mn, mx, strict, batch, image, img_seed, nm,
    nm_seed, quirk_rw``.

    ``sharded``: ``tests/test_fuzz_sharded.py``'s thirteen configurations
    (seed 20260820) with their meshes ``(data, y, x)`` and frames (``batch``
    = data), keys ``name, h, w, sigma, mn, mx, mesh, batch, img_seed``.

    ``fixed``: one frame configuration, not drawn: sigma 0.1 (taps 1.93e-22,
    1.0, 1.93e-22) on three 96x130 ramps XOR noise/4, where JAX's blur
    writes -32768 and the port must still equal ``golden``.
    ``thresholds``: the names of :data:`THRESHOLD_CONFIGS`.
    """
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        h = _sweep_size(rng, max_hw[0], ROW_EDGES)
        w = _sweep_size(rng, max_hw[1], COL_EDGES)
        sigma = float(rng.choice(SWEEP_SIGMAS))
        mn = int(rng.integers(0, 81))
        mx = min(mn + int(rng.integers(1, 121)), 255)
        if i % 8 == 2:
            mn, mx = FORCED_THRESHOLDS[i // 8 % 3]
        frames.append({
            "name": f"sweep{i}", "h": h, "w": w, "sigma": sigma, "mn": mn,
            "mx": mx, "strict": i % 2 == 1,
            "batch": int(rng.choice([1, 2, 3, 5])),
            "image": ("noise", "scene")[int(rng.integers(0, 2))],
            "img_seed": int(rng.integers(0, 2**31)),
            "nm": ("random", "snake", "sparse")[i // 4 % 3] if i % 4 == 3
            else None,
            "nm_seed": int(rng.integers(0, 2**31)),
            "quirk_rw": _quirk(rng, h, w)})
    fuzz = np.random.default_rng(20260817)       # test_fuzz_bitexact.py
    jax_cfgs = []
    for i in range(8):
        h, w = int(fuzz.integers(16, 700)), int(fuzz.integers(16, 700))
        sigma = float(fuzz.choice([0.5, 0.75, 1.0, 1.4, 2.0, 2.5, 3.0]))
        mn = int(fuzz.integers(0, 80))
        mx = mn + int(fuzz.integers(1, 120))
        jax_cfgs.append((f"fuzz{i}", h, w, sigma, mn, mx, 1000 + i))
    jax_cfgs += [("fuzz8", 1441, 123, 1.0, 30, 90, 1008),
                 ("fuzz9", 1447, 257, 2.0, 0, 40, 1009)]
    jax_cfgs += [(f"degenerate_{h}x{w}", h, w, 1.0, 50, 150, 17)
                 for h, w in ((1, 50), (50, 1), (1, 1), (2, 2), (3, 200),
                              (200, 3))]
    for name, h, w, sigma, mn, mx, img_seed in jax_cfgs:
        frames.append({
            "name": name, "h": h, "w": w, "sigma": sigma, "mn": mn,
            "mx": mx, "strict": False, "batch": 1, "image": "noise",
            "img_seed": img_seed, "nm": None, "nm_seed": 0,
            "quirk_rw": _quirk(rng, h, w)})
    fuzz = np.random.default_rng(20260820)       # test_fuzz_sharded.py
    sharded = []
    for i in range(10):
        h, w = int(fuzz.integers(16, 400)), int(fuzz.integers(16, 400))
        sigma = float(fuzz.choice([0.5, 1.0, 1.4, 2.0, 2.5]))
        mn = int(fuzz.integers(0, 80))
        mx = mn + int(fuzz.integers(1, 120))
        sharded.append((i, h, w, sigma, mn, mx, MESHES[i % len(MESHES)]))
    sharded += [(10, 131, 251, 1.0, 30, 90, (1, 2, 4)),
                (11, 10, 12, 2.0, 20, 60, (1, 2, 4)),
                (12, 97, 203, 1.0, 0, 40, (2, 2, 2))]
    fixed = [{"name": "sigma0.1", "h": 96, "w": 130, "sigma": 0.1, "mn": 30,
              "mx": 90, "strict": False, "batch": 3, "image": "ramp",
              "img_seed": 7, "nm": None, "nm_seed": 0, "quirk_rw": (0, 0)}]
    return {"frames": frames, "sharded": [
        {"name": f"sharded{i}", "h": h, "w": w, "sigma": sigma, "mn": mn,
         "mx": mx, "mesh": mesh, "batch": mesh[0], "img_seed": 2000 + i}
        for i, h, w, sigma, mn, mx, mesh in sharded],
        "fixed": fixed, "thresholds": list(THRESHOLD_CONFIGS)}


def sweep_images(cfg):
    """uint8 ``(batch, h, w)`` frames of a sweep configuration: uniform
    noise from ``img_seed`` (JAX's fuzz frames), a diagonal ramp XOR
    noise/4 from ``img_seed + b``, or the headline scene
    (``bench_torch.make_image``) from ``img_seed + b``."""
    b, h, w = cfg["batch"], cfg["h"], cfg["w"]
    if cfg.get("image", "noise") == "noise":
        return np.random.default_rng(cfg["img_seed"]).integers(
            0, 256, (b, h, w), np.uint8)
    if cfg["image"] == "ramp":
        y, x = np.mgrid[:h, :w]
        ramp = ((y + x) * 255 // max(h + w - 2, 1)).astype(np.uint8)
        return np.stack([ramp ^ (np.random.default_rng(
            cfg["img_seed"] + i).integers(0, 256, (h, w), np.uint8) // 4)
            for i in range(b)])
    return np.stack([make_image(h, w, seed=cfg["img_seed"] + i)
                     for i in range(b)])


def sweep_nm(cfg):
    """The configuration's extra int16 NMS map ``(h, w)`` for the engines,
    or None: a random map, the serpentine or sparse chains, cropped."""
    kind, h, w = cfg["nm"], cfg["h"], cfg["w"]
    if kind is None:
        return None
    rng = np.random.default_rng(cfg["nm_seed"])
    if kind == "snake":
        return snake_nm(max(h, 9), max(w, 9))[:h, :w].astype(np.int16)
    return (random_nm if kind == "random" else sparse_nm)(rng, h, w)


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
                "frontend": 4, "hysteresis_packed": 4},
                f"{name} stream: {stats['frames']} frames, launches {counts}")
            check_pngs(d(name), refs, f"{name} stream")
            runs[name] = {"stats": stats, "launches": counts}
        first, _ = counted([f"synthetic:{hd}x16", *args, "--batch", "4",
                            "--max-frames", "8", "--resume", "--json",
                            "--out-dir", d("resume")])
        stats, counts = counted(stream + ["--resume", "--out-dir",
                                          d("resume")])
        check(first["frames"] == 8 and stats["skipped_batches"] == 2
              and stats["frames"] == 8 and counts["frontend"] == 2
              and counts["hysteresis_packed"] == 2,
              f"resume: {first} then {stats}, launches {counts}")
        check_pngs(d("resume"), refs, "resumed stream")
        runs["resume"] = {"stats": stats, "launches": counts}

        # 4K
        frames4k = [imageio.synthetic_image(*hw4k, seed=i) for i in range(4)]
        stats, counts = counted([f"synthetic:{hw4k[0]}x{hw4k[1]}x4", *args, "--batch",
                                 "2", "--json", "--out-dir", d("4k")])
        check(counts == {"frontend": 2, "hysteresis_packed": 2},
              f"4K stream launches {counts}")
        check_pngs(d("4k"), refs_of(frames4k), "4K stream")
        runs["4k"] = {"stats": stats, "launches": counts}

        # the native feeder: a raw8 file and a PGM directory
        np.stack(frames[:8]).tofile(d("frames.raw"))
        stats, counts = counted([f"raw8:{d('frames.raw')}:{hd}x8", *args,
                                 "--batch", "4", "--native-feeder", "--json",
                                 "--out-dir", d("raw8")])
        check(counts["frontend"] == 2 and stats["feeder"]["produced"] == 8
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
            check(counts["frontend"] == 2 and ("feeder" in stats) == bool(
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
        check(kfe.launches == 8 and khp.launches == 8,
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
    from canny_edge_tpu_torch.utils.opcount import audit_compiled
    from canny_edge_tpu_torch.utils.roofline import (HBM_BYTES_PER_S,
                                                     SEPARATE_OPS_PER_S,
                                                     kernel_bounds)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def u32eq(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    rep = {}
    t0 = time.perf_counter()
    # ---- K1 at windows 17 to 55 (the tile path's unrolled instantiations) ----
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
    # K1 block: the window read once, the two masks written once; K2: two
    # masks read and one written (utils/roofline.py:kernel_bounds)
    kb = kernel_bounds(window=len(kern), block=(hl, wl), extended=(eh, ew))
    for k, key in (("k1_block", "frontend_block"),
                   ("k2_quirk", "hysteresis_packed_quirk")):
        kt[f"{k}_bound_ms"] = kb[key]["bound_ms"]
        kt[f"{k}_bound_by"] = kb[key]["bound_by"]
    # the audited floor, as PERF.md's rows 1 and 3 take it: the larger of
    # the bound's bytes at the HBM rate and the plain version's audited alu
    # operations (utils/opcount.py; the flood's rounds those of this data)
    # at the rate of separate operations
    for k, fn, px, nbytes in (
            ("k1_block", lambda: Wn.frontend_block(
                win, 0, wl, H, W, kern, (MN, MX)), hl * wl,
             win.numel() + 2 * hl * (wl // 32) * 4),
            ("k2_quirk", lambda: P.hysteresis_packed_masks(
                weak, strong, eh, ew, strict=True, quirk_rw=(1, 1)),
             eh * ew, 3 * weak.numel() * 4)):
        alu = audit_compiled(fn, pixels=px)["buckets"].get("alu", 0.0)
        kt[f"{k}_audited_alu_per_px"] = alu
        kt[f"{k}_audited_floor_ms"] = max(
            nbytes / HBM_BYTES_PER_S, alu * px / SEPARATE_OPS_PER_S) * 1e3
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


def batch_phase(dev, time_ms, host_ms, device_ms, hw=SIZES["1080p"],
                hw4k=SIZES["4k"], batch=8, batch4k=2,
                ragged=((257, 333), (1, 1000), (40, 1), (64, 33))):
    """Phase 13: the batch path.  K1 (both modes), K2 (four modes,
    component and strict), K3 and K4 on ``(B, H, W)`` batches, each one
    launch, held bit-equal to B single-frame launches and to the plain
    versions frame by frame, with K3's and K4's sweeps equal to the most of
    a frame; ``batch`` frames at ``hw``, ``batch4k`` at ``hw4k``, a mixed
    batch (an empty map, the serpentine, a random map) and batches of 3 at
    each ``ragged`` shape (unaligned frame starts).  Then the main path's
    launch counts (exactly one launch of each stage a batch) and the times
    of a batch against its frames one by one.  Returns ``(report, kernel
    entries of the kernels line)``."""
    import torch

    from canny_edge_tpu_torch import CannyTorch
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis as k3
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
    from canny_edge_tpu_torch.kernels.fused import IMPLS, canny_fused
    from canny_edge_tpu_torch.ops import banded as Bd
    from canny_edge_tpu_torch.ops import dilate as Dl
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import window as Wn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from canny_edge_tpu_torch.utils.roofline import kernel_bounds

    t0 = time.perf_counter()
    kern = gaussian_kernel(SIGMA)
    taps = torch.from_numpy(kern).to(dev)
    rng = np.random.default_rng(13)
    mods = {"frontend": kfe, "hysteresis_packed": khp,
            "hysteresis_dilate": k3, "hysteresis_banded": k4}
    rep = {"cases": [], "sweeps": {}}
    err = dict.fromkeys(mods, 0)
    plain_s = {}                 # seconds of the plain versions, by case

    def sync():
        torch.cuda.synchronize()

    def u32eq(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def on_card(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    def plain(tag, fn):
        """``fn()``, a stack of plain versions, timed on the card."""
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        plain_s[tag] = time.perf_counter() - t
        return out

    def check_k1(tag, imgs):
        """K1 on the batch ``imgs`` against its frames and the plain
        version; returns the batch's NMS map."""
        frames = list(imgs.unbind(0))
        nm = kfe.frontend(imgs, taps)
        weak, strong = kfe.frontend(imgs, taps, (MN, MX))
        singles = [kfe.frontend(f, taps) for f in frames]
        masks = [kfe.frontend(f, taps, (MN, MX)) for f in frames]
        ref = torch.stack([Wn.frontend_nm(f, kern) for f in frames])
        pm = plain(f"frontend/{tag}", lambda: [
            Wn.frontend_nm(f, kern, (MN, MX)) for f in frames])
        sync()
        err["frontend"] = max(err["frontend"], int(
            (nm.to(torch.int32) - ref).abs().max()))
        check(nm.shape == imgs.shape and torch.equal(nm, torch.stack(singles))
              and torch.equal(nm.to(torch.int32), ref),
              f"K1 batch NMS map differs: {tag}")
        for i in (0, 1):
            check(u32eq((weak, strong)[i], torch.stack([m[i] for m in masks]))
                  and u32eq((weak, strong)[i], torch.stack([m[i] for m in pm]))
                  and u32eq((weak, strong)[i], P.pack_mask(ref >= (MN, MX)[i])),
                  f"K1 batch masks differ: {tag}")
        return nm

    def check_k2(tag, nm, lo, hi):
        """K2 in its four modes, component and strict, on the batch ``nm``
        against its frames and the plain flood."""
        h, w = nm.shape[-2:]
        frames = list(nm.unbind(0))
        weak, strong = P.pack_mask(nm >= lo), P.pack_mask(nm >= hi)
        for strict in (False, True):
            ref = plain(f"hysteresis_packed{'_strict' * strict}/{tag}",
                        lambda: torch.stack([
                            P.hysteresis_packed_masks(
                                wf, sf, h, w, strict=strict)[0]
                            for wf, sf in zip(weak, strong)]))
            ref16 = P.unpack_edges(ref, w)
            calls = dict(P.calls)
            outs = [khp.hysteresis_packed(weak, strong, h, w, strict=strict),
                    khp.hysteresis_packed(weak, strong, h, w, strict=strict,
                                          edges_int16=True)]
            for t in (nm.to(torch.int16), nm.to(torch.int32)):
                outs += [khp.hysteresis_packed_nm(t, lo, hi, strict=strict,
                                                  packed_out=True),
                         khp.hysteresis_packed_nm(t, lo, hi, strict=strict)]
            outs += [torch.stack([khp.hysteresis_packed_nm(
                f, lo, hi, strict=strict, packed_out=packed)
                for f in frames]) for packed in (True, False)]
            sync()
            check(P.calls == calls, f"K2 batch ran a plain pack/unpack: {tag}")
            for o in outs:
                if o.dtype == torch.int16:
                    check(o.shape == nm.shape and torch.equal(o, ref16),
                          f"K2 batch int16 output differs: {tag} {strict}")
                    err["hysteresis_packed"] = max(
                        err["hysteresis_packed"],
                        int((o - ref16).abs().max()) // 255)
                else:
                    check(u32eq(o, ref),
                          f"K2 batch packed output differs: {tag} {strict}")

    def check_engines(tag, nm, lo, hi,
                      plain_engines=("hysteresis_dilate", "hysteresis_banded")):
        """K3 and K4 on the batch ``nm`` against their frames (sweeps: the
        batch's is the most of a frame) and the plain versions; an engine
        not in ``plain_engines`` against the plain packed flood, the same
        function, where its own plain sweeps take seconds to minutes (K3 on
        the serpentine, K4's row loop over a 257-row band)."""
        frames = list(nm.unbind(0))
        flood = None
        for name, fn, plain_fn in (
                ("hysteresis_dilate", k3.hysteresis_dilate,
                 Dl.hysteresis_dilate),
                ("hysteresis_banded", k4.hysteresis_banded,
                 Bd.hysteresis_banded)):
            out, sweeps = fn(nm, lo, hi, return_sweeps=True)
            singles = [fn(f, lo, hi, return_sweeps=True) for f in frames]
            sync()
            most = max(s for _, s in singles)
            check(out.shape == nm.shape
                  and torch.equal(out, torch.stack([o for o, _ in singles]))
                  and sweeps == most,
                  f"{name} batch differs from its frames: {tag} (sweeps "
                  f"{sweeps}, frames {[s for _, s in singles]})")
            if name in plain_engines:
                kw = ({"band_h": k4.banded_stats(frames[0], lo, hi)[1][
                    "band_h"]} if name == "hysteresis_banded" else {})
                refs = plain(f"{name}/{tag}", lambda: [
                    plain_fn(f, lo, hi, return_sweeps=True, **kw)
                    for f in frames])
                ref = torch.stack([r for r, _ in refs])
                check(most == max(s for _, s in refs),
                      f"{name}: frames' sweeps {[s for _, s in singles]}, "
                      f"plain {[s for _, s in refs]}: {tag}")
            else:
                if flood is None:
                    flood = plain(f"flood/{tag}",
                                  lambda: P.hysteresis_packed(nm, lo, hi))
                ref = flood
            check(torch.equal(out, ref),
                  f"{name} batch differs from the plain version: {tag}")
            err[name] = max(err[name], int(
                (out.to(torch.int32) - ref).abs().max()))
            rep["sweeps"][f"{name}/{tag}"] = {
                "batch": sweeps, "frames": [s for _, s in singles]}

    # ---- bit-equality: the batches ----
    imgs8 = on_card(np.stack([make_image(*hw, seed=s) for s in range(batch)]))
    imgs4k = on_card(np.stack([make_image(*hw4k, seed=s)
                               for s in range(batch4k)]))
    for tag, imgs in ((f"{batch}x{hw[0]}x{hw[1]}", imgs8),
                      (f"{batch4k}x{hw4k[0]}x{hw4k[1]}", imgs4k)):
        nm = check_k1(tag, imgs)
        check_k2(tag, nm, MN, MX)
        check_engines(tag, nm, MN, MX)
        rep["cases"].append(tag)
    h, w = hw
    mixed = on_card(np.stack([np.zeros((h, w), np.int32), snake_nm(h, w),
                              random_nm(rng, h, w).astype(np.int32)]))
    check_k2("mixed", mixed, 10, 100)
    check_engines("mixed", mixed, 10, 100, plain_engines=())
    rep["cases"].append("mixed: empty, serpentine, random")
    for rh, rw in ragged:
        tag = f"3x{rh}x{rw}"
        nm = check_k1(tag, on_card(np.stack([make_image(rh, rw, seed=s)
                                             for s in range(3)])))
        rnd = on_card(np.stack([random_nm(rng, rh, rw) for _ in range(3)]))
        for t, m in ((tag, nm), (f"{tag}/random", rnd)):
            check_k2(t, m, MN, MX)
            check_engines(t, m, MN, MX, ("hysteresis_dilate",) if rh > 200
                          else ("hysteresis_dilate", "hysteresis_banded"))
            rep["cases"].append(t)
    rep["check_s"] = time.perf_counter() - t0
    log(f"batch path bit-equal on {rep['cases']}: sweeps {rep['sweeps']}")

    # ---- the main path: one launch of each stage a batch ----
    t1 = time.perf_counter()
    models = {"fused": CannyTorch(SIGMA, device=dev),
              "pallas": CannyTorch(SIGMA, device=dev, backend="pallas"),
              "fused-strict": CannyTorch(SIGMA, device=dev,
                                         hysteresis_mode="strict-reference")}
    for m in mods.values():
        m.launches = m.batch_launches = 0
    one_each = {"frontend": 1, "hysteresis_packed": 1}
    expect, outs, per_run = {}, {}, {}
    for size, imgs in (("1080p", imgs8), ("4k", imgs4k)):
        runs = {f"{m}.batch": (lambda m=m: models[m].batch(imgs, MN, MX),
                               one_each) for m in models}
        runs["fused.batch_packed"] = (
            lambda: models["fused"].batch_packed(imgs, MN, MX), one_each)
        for impl in IMPLS:
            engine = {"packed": "hysteresis_packed", "packed-xla": None,
                      "banded": "hysteresis_banded",
                      "dilate": "hysteresis_dilate"}[impl]
            runs[f"canny_fused/{impl}"] = (
                lambda impl=impl: canny_fused(imgs, MN, MX, kernel_vals=taps,
                                              hysteresis_impl=impl),
                {"frontend": 1, **({engine: 1} if engine else {})})
        for run, (fn, want) in runs.items():
            before = {k: m.launches for k, m in mods.items()}
            outs[run, size] = fn()
            per_run[f"{run}/{size}"] = {
                k: m.launches - before[k] for k, m in mods.items()}
            expect[f"{run}/{size}"] = {k: want.get(k, 0) for k in mods}
    sync()
    launches = {k: m.launches for k, m in mods.items()}
    batch_launches = {k: m.batch_launches for k, m in mods.items()}
    log(f"batch path launches: {launches} by run {per_run}")
    check(per_run == expect, f"the batch path's launches {per_run}, expected "
          f"exactly one of each stage a batch: {expect}")
    check(batch_launches == launches and all(launches.values()),
          f"batch launches {batch_launches} of {launches}")
    for size, imgs in (("1080p", imgs8), ("4k", imgs4k)):
        refs = {s: torch.stack([P.hysteresis_packed(Wn.frontend_nm(f, kern),
                                                    MN, MX, strict=s)
                                for f in imgs]) for s in (False, True)}
        for (run, sz), got in outs.items():
            if sz != size:
                continue
            want = refs["strict" in run]
            if run.endswith("batch_packed"):
                got = P.unpack_edges(got, want.shape[-1])
            check(torch.equal(got, want),
                  f"{run} on {size} differs from the plain pipeline")
        single = torch.stack([models["fused"](f, MN, MX) for f in imgs])
        check(torch.equal(outs["fused.batch", size], single),
              f"fused batch differs from its frames one by one: {size}")
    rep["launches"] = launches
    rep["by_run"] = per_run
    rep["main_path_s"] = time.perf_counter() - t1

    # ---- times: a batch against its frames one by one ----
    t1 = time.perf_counter()
    times = {}
    model = models["fused"]
    for size, imgs in (("1080p", imgs8), ("4k", imgs4k)):
        b, h, w = imgs.shape
        frames = list(imgs.unbind(0))
        nm = kfe.frontend(imgs, taps)
        nms = list(nm.unbind(0))
        weak, strong = kfe.frontend(imgs, taps, (MN, MX))
        wf, sf = list(weak.unbind(0)), list(strong.unbind(0))
        fns = {
            "k1": (lambda: kfe.frontend(imgs, taps, (MN, MX)),
                   lambda: [kfe.frontend(f, taps, (MN, MX)) for f in frames]),
            "k2": (lambda: khp.hysteresis_packed(weak, strong, h, w),
                   lambda: [khp.hysteresis_packed(x, y, h, w)
                            for x, y in zip(wf, sf)]),
            "k3": (lambda: k3.hysteresis_dilate(nm, MN, MX),
                   lambda: [k3.hysteresis_dilate(f, MN, MX) for f in nms]),
            "k4": (lambda: k4.hysteresis_banded(nm, MN, MX),
                   lambda: [k4.hysteresis_banded(f, MN, MX) for f in nms]),
            "fused_batch": (lambda: model.batch(imgs, MN, MX),
                            lambda: [model(f, MN, MX) for f in frames]),
        }
        t = {"frames": b}
        for key, (fb, fs) in fns.items():
            t[f"{key}_ms"] = time_ms(fb, 20, 3)
            t[f"{key}_frames_ms"] = time_ms(fs, 10, 3)
            t[f"{key}_host_ms"] = host_ms(fb, 100)
            t[f"{key}_frames_host_ms"] = host_ms(fs, 20)
            for tag, fn in (("", fb), ("_frames", fs)):
                by = device_ms(fn)
                t[f"{key}{tag}_device_ms"] = (sum(by.values()) if by
                                              else "not measured")
        kb = kernel_bounds(hw=(h, w), window=len(kern), batch=b)
        for k, name in (("k1", "frontend"), ("k2", "hysteresis_packed"),
                        ("k3", "hysteresis_dilate"),
                        ("k4", "hysteresis_banded")):
            t[f"{k}_bound_ms"] = kb[name]["bound_ms"]
            t[f"{k}_bound_by"] = kb[name]["bound_by"]
        times[size] = t
        log(f"batch times {size}: {t}")
    rep["times"] = times
    rep["times_s"] = time.perf_counter() - t1

    t8, t4 = times["1080p"], times["4k"]
    tag8, tag4 = (f"{batch}x{hw[0]}x{hw[1]}",
                  f"{batch4k}x{hw4k[0]}x{hw4k[1]}")
    entries = []
    for k, name, src, line in (
            ("k1", "frontend", "frontend.cu", "frontend.py:153"),
            ("k2", "hysteresis_packed", "hysteresis_packed.cu",
             "hysteresis_packed.py:180"),
            ("k3", "hysteresis_dilate", "hysteresis_dilate.cu",
             "hysteresis.py:41"),
            ("k4", "hysteresis_banded", "hysteresis_banded.cu",
             "hysteresis_v2.py:70")):
        entries.append({
            "name": f"{name}_batch", "route": "cuda",
            "source": f"canny_edge_tpu_torch/kernels/csrc/{src}",
            "replaces": ("canny_edge_tpu/kernels/"
                         + ("hysteresis_packed.py:348" if k == "k2" else
                            "fused.py:47") + f" (jax.vmap over "
                         f"canny_edge_tpu/kernels/{line})"),
            "launches": batch_launches[name], "max_abs_err": err[name],
            "ms": t8[f"{k}_ms"],
            "plain_ms": plain_s[f"{name}/{tag8}"] * 1e3,
            "bound_ms": t8[f"{k}_bound_ms"], "bound_by": t8[f"{k}_bound_by"],
            "library_ms": None, "match": True, "batch": batch, "of": name,
            "shape": tag8, "frames_ms": t8[f"{k}_frames_ms"],
            "device_ms": t8[f"{k}_device_ms"],
            "frames_device_ms": t8[f"{k}_frames_device_ms"],
            "host_ms": t8[f"{k}_host_ms"], "ms_4k": t4[f"{k}_ms"],
            "shape_4k": tag4, "bound_ms_4k": t4[f"{k}_bound_ms"],
            "plain_ms_4k": plain_s[f"{name}/{tag4}"] * 1e3})
    rep["plain_s"] = plain_s
    rep["max_abs_err"] = err
    rep["s"] = time.perf_counter() - t0
    return rep, entries


ENGINE_THRESHOLDS = {"random": (10, 95), "snake": (10, 100),
                     "sparse": (10, 100)}


def _oracle_init():
    import torch

    torch.set_num_threads(1)


def _oracle(kind, *args):
    """One CPU reference of phase 14, computed in a worker process:

    * ``golden``: (frames, sigma, mn, mx, strict) -> the port's NumPy oracle
      on each frame (its BFS in strict mode);
    * ``cpu``: (frames, sigma, mn, mx, strict) -> ``CannyTorch`` on the CPU:
      the batch's int16 edges and its packed edges;
    * ``k3``: (map, lo, hi) -> the plain K3 (``ops/dilate.py``): edges and
      sweeps;
    * ``k4``: (map, lo, hi, band_h) -> the plain K4 (``ops/banded.py``) at
      ``band_h``: edges and sweeps;
    * ``mirror``: (weak, strong, h, w, strict, quirk_rw) -> K2's tile mirror
      (``ops/packed_tiles.py``): packed edges and steps;
    * ``golden_pairs``: (frames, sigma, pairs, strict) -> the oracle's edges
      of the frames at each threshold pair (its NMS map once a frame);
    * ``cpu_pairs``: (frames, sigma, mn, mx, kinds, strict) -> for each
      kind of :func:`threshold_pair`, ``canny_fn`` (``xla``) on the CPU and
      ``canny_fn_packed``'s edges;
    * ``k34_pair``: (map, kind, mn, mx) -> the plain K3's and K4's edges at
      the pair."""
    import torch

    from canny_edge_tpu_torch import CannyTorch, golden
    from canny_edge_tpu_torch.ops import banded as Bd
    from canny_edge_tpu_torch.ops import dilate as Dl
    from canny_edge_tpu_torch.ops import packed_tiles as Tl

    if kind == "golden":
        frames, sigma, mn, mx, strict = args
        if not strict:
            return np.stack([golden.canny(f, sigma, mn, mx) for f in frames])
        return np.stack([golden.hysteresis_strict(golden.nonmax_suppression(
            *golden.sobel(golden.gaussian_blur(f, sigma))), mn, mx)
            for f in frames])
    if kind == "cpu":
        frames, sigma, mn, mx, strict = args
        model = CannyTorch(sigma, hysteresis_mode=("strict-reference"
                                                   if strict else "component"),
                           device="cpu")
        return (model.batch(frames, mn, mx).numpy(),
                model.batch_packed(frames, mn, mx).view(torch.int32).numpy())
    if kind == "golden_pairs":
        frames, sigma, pairs, strict = args
        hyst = golden.hysteresis_strict if strict else golden.hysteresis
        nms = [golden.nonmax_suppression(*golden.sobel(
            golden.gaussian_blur(f, sigma))) for f in frames]
        return [np.stack([hyst(nm, lo, hi) for nm in nms])
                for lo, hi in pairs]
    if kind == "cpu_pairs":
        from canny_edge_tpu_torch import models
        from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

        frames, sigma, mn, mx, kinds, strict = args
        kv = gaussian_kernel(sigma)
        mode = "strict-reference" if strict else "component"
        imgs = torch.from_numpy(frames)
        out = []
        for k in kinds:
            a, c = threshold_pair(k, mn, mx)
            out.append((models.canny_fn(imgs, a, c, kernel_vals=kv,
                                        hysteresis_mode=mode).numpy(),
                        models.canny_fn_packed(
                            imgs, a, c, kernel_vals=kv,
                            hysteresis_mode=mode).view(torch.int32).numpy()))
        return out
    if kind == "k34_pair":
        nm, k, mn, mx = args
        a, c = threshold_pair(k, mn, mx)
        m = torch.from_numpy(nm)
        return (Dl.hysteresis_dilate(m, a, c).numpy(),
                Bd.hysteresis_banded(m, a, c).numpy())
    if kind == "k3":
        nm, lo, hi = args
        edges, sweeps = Dl.hysteresis_dilate(torch.from_numpy(nm), lo, hi,
                                             return_sweeps=True)
        return edges.numpy(), sweeps
    if kind == "k4":
        nm, lo, hi, band_h = args
        edges, sweeps = Bd.hysteresis_banded(torch.from_numpy(nm), lo, hi,
                                             band_h=band_h, return_sweeps=True)
        return edges.numpy(), sweeps
    weak, strong, h, w, strict, quirk_rw = args
    edges, steps, _ = Tl.hysteresis_packed_tiles(
        torch.from_numpy(weak).view(torch.uint32),
        torch.from_numpy(strong).view(torch.uint32), h, w, strict=strict,
        quirk_rw=quirk_rw)
    return edges.view(torch.int32).numpy(), steps


def first_diff(got, want):
    """The first (index) at which two arrays differ, their shapes where
    those differ, or None."""
    got, want = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
                 for x in (got, want))
    if got.shape != want.shape:
        return f"shape {got.shape} against {want.shape}"
    if got.ndim == 0:
        return None if got == want else f"{got} against {want}"
    at = np.argwhere(got != want)
    return tuple(int(i) for i in at[0]) if len(at) else None


def sweep_phase(dev, cfgs=None, workers=6, chunked=(65537, 1, 3)):
    """Phase 14: the seeded sweep (:func:`sweep_configs`) on the card.

    For every frame configuration, each comparison bit-equal:
    * K1 in NMS and threshold mode on every frame and, where B > 1, on the
      batch, against ``ops.window.frontend_nm`` on the card;
    * K2 on every NMS map (K1's and the extra one) in the configuration's
      mode: masks -> packed, masks -> int16, NMS map -> int16 and -> packed
      against the plain flood (``ops/packed.py``) on the card and the tile
      mirror (its steps at most the mirror's); strict with the quirk at the
      configuration's (row, word), where :func:`plant_quirk` plants the
      case the fix decides, against both; the batch against the stacked
      plain floods;
    * K3 and K4 on every map and on the batch, the batch against its frames
      (its sweeps the most of a frame), each frame's edges and sweeps
      against ``ops/dilate.py`` and ``ops/banded.py`` (K4 at the band that
      ran); the serpentine, whose plain dilation takes minutes, holds K3
      against the plain packed flood;
    * ``CannyTorch`` with each backend on the batch against its frames one
      by one and against ``CannyTorch`` on the CPU, ``canny_fn_packed``
      against the CPU's packed edges, and the edges against ``golden``.
    The fixed configuration (sigma 0.1) runs the same, with every backend
    against ``golden``; the configurations named in ``cfgs["thresholds"]``
    then run each kind of :func:`threshold_pair` (``check_thresholds``), the
    sharded ones through ``ShardedCanny``, which truncates, against its
    integer run.
    Every sharded configuration runs ``ShardedCanny`` on an in-process mesh
    of its blocks on the card, component and strict, against the fused
    backend on the card and ``golden``; the static engine (K1 block mode,
    K2's quirk) and the generic engine must both run.  Then K1 on a batch of
    ``chunked`` ``(frames, h, w)`` (a launch a chunk of at most 65535; None:
    not run) against the plain version of its 251 distinct frames.

    The CPU references (``golden``, ``CannyTorch`` on the CPU, the plain K3
    and K4, K2's tile mirror) run in ``workers`` spawned processes while
    the card works.  Each mismatch is printed with its configuration and
    first differing pixel, and the phase then fails.  Returns the report."""
    import multiprocessing

    import torch

    from canny_edge_tpu_torch import CannyTorch
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis as k3
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
    from canny_edge_tpu_torch.models import (canny_fn, canny_fn_batched,
                                             canny_fn_packed)
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import window as Wn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from canny_edge_tpu_torch.ops.thresholds import threshold_bound
    from canny_edge_tpu_torch.parallel import ShardedCanny, make_mesh

    t0 = time.perf_counter()
    cfgs = cfgs or sweep_configs()
    mods = {"frontend": kfe, "hysteresis_packed": khp,
            "hysteresis_dilate": k3, "hysteresis_banded": k4}
    for m in mods.values():
        m.launches = m.batch_launches = 0
    kfe.block_launches = khp.quirk_launches = 0
    cases = {}
    bands = {}                    # K4's band that ran, by configuration
    mismatches = []
    pending = []                  # (tag, cfg, future, compare(result))
    thr_ran = set()               # configurations that ran threshold cases

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def host(x):
        x = x.detach().cpu()
        return (x.view(torch.int32) if x.dtype == torch.uint32 else x).numpy()

    def same(tag, cfg, got, want):
        """Count the case; record a mismatch with its first pixel."""
        cases[tag] = cases.get(tag, 0) + 1
        at = first_diff(got, want)
        if at is not None:
            mismatches.append({"case": tag, "config": cfg, "first": at})
            log(f"sweep MISMATCH {tag}: first differing pixel {at}, "
                f"configuration {cfg}")

    def later(tag, cfg, fut, compare):
        pending.append((tag, cfg, fut, compare))

    def on_card(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    def check_k2(cfg, what, m, lo, hi, strict):
        """K2's modes on one map against the plain flood and its mirror."""
        h, w = m.shape
        weak, strong = P.pack_mask(m >= lo), P.pack_mask(m >= hi)
        ref = P.hysteresis_packed_masks(weak, strong, h, w, strict=strict)[0]
        ref16 = P.unpack_edges(ref, w)
        out, steps = khp.hysteresis_packed(weak, strong, h, w, strict=strict,
                                           return_steps=True)
        mode = "strict" if strict else "component"
        same(f"k2_masks_packed_{mode}", cfg, host(out), host(ref))
        same(f"k2_masks_int16_{mode}", cfg, host(khp.hysteresis_packed(
            weak, strong, h, w, strict=strict, edges_int16=True)), host(ref16))
        same(f"k2_nm_int16_{mode}", cfg, host(khp.hysteresis_packed_nm(
            m, lo, hi, strict=strict)), host(ref16))
        same(f"k2_nm_packed_{mode}", cfg, host(khp.hysteresis_packed_nm(
            m, lo, hi, strict=strict, packed_out=True)), host(ref))
        steps, out = int(steps), host(out)
        later(f"k2_mirror_{mode}", cfg, pool.submit(
            _oracle, "mirror", host(weak), host(strong), h, w, strict,
            (0, 0)), lambda r, out=out, steps=steps, what=what: (
                r[0] if steps <= r[1] else
                f"{what}: K2 took {steps} steps, its mirror {r[1]}", out))
        q = tuple(cfg["quirk_rw"])
        if h >= 2 and w >= 3:       # the fix's case planted at the quirk
            weak, strong = (P.pack_mask(x) for x in plant_quirk(
                m >= lo, m >= hi, q))
            refq = P.hysteresis_packed_masks(weak, strong, h, w, strict=True,
                                             quirk_rw=q)[0]
            comp = P.hysteresis_packed_masks(weak, strong, h, w)[0]
            at = (q[0], 32 * q[1] + 1)
            check(not P.unpack_mask(refq, w)[at]
                  and P.unpack_mask(comp, w)[at],
                  f"the planted quirk case decides nothing: {cfg}")
            outq = host(khp.hysteresis_packed(weak, strong, h, w,
                                              strict=True, quirk_rw=q))
            same("k2_quirk", cfg, outq, host(refq))
            later("k2_quirk_mirror", cfg, pool.submit(
                _oracle, "mirror", host(weak), host(strong), h, w, True, q),
                lambda r, outq=outq: (r[0], outq))
        return ref

    def check_engines(cfg, what, maps, lo, hi, dilate=True):
        """K3 and K4 on a batch of maps (one launch) against its frames,
        each frame against the plain engines at the band K4 ran."""
        flood = P.hysteresis_packed(maps, lo, hi)
        for name, fn, stats in (
                ("k3", k3.hysteresis_dilate, k3.dilate_stats),
                ("k4", k4.hysteresis_banded, k4.banded_stats)):
            out, sweeps = fn(maps, lo, hi, return_sweeps=True)
            singles = [stats(f, lo, hi) for f in maps]
            same(f"{name}_batch" if len(maps) > 1 else name, cfg, host(out),
                 host(torch.stack([o for o, _ in singles])))
            most = max(s["sweeps"] for _, s in singles)
            if sweeps != most:
                same(f"{name}_batch_sweeps", cfg, sweeps, most)
            same(f"{name}_flood", cfg, host(out), host(flood))
            if name == "k3" and not dilate:
                continue          # the serpentine: held against the flood
            if name == "k4":
                bands[cfg["name"]] = singles[0][1]["band_h"]
            for i, (o, st) in enumerate(singles):
                args = (host(maps[i]), lo, hi) + (
                    (st["band_h"],) if name == "k4" else ())
                later(f"{name}_plain", cfg, pool.submit(_oracle, name, *args),
                      lambda r, o=host(o), n=st["sweeps"], i=i: (
                          r[0] if n == r[1] else
                          f"{what}[{i}]: {n} sweeps, plain {r[1]}", o))

    def check_thresholds(cfg, imgs, imgs_np, nm_b, kern, taps, models,
                         cpu_ref):
        """Every kind of :func:`threshold_pair` on one frame configuration:
        K1's threshold mode, K2's NMS-map entry, K3 and K4 against their
        plain versions (K1 and K2 on the card, K3 and K4 on the CPU for the
        first frame; the batch against the plain packed flood on the card);
        ``canny_fn``, ``canny_fn_batched`` and ``canny_fn_packed`` of each
        backend against the CPU pipeline and ``golden`` (in strict mode
        only the finite pairs: the reference's BFS defines no other); the
        model classes, which truncate, against the CPU at ``(mn, mx)``."""
        thr_ran.add(cfg["name"])
        b = imgs_np.shape[0]
        sigma, mn, mx, strict = (cfg["sigma"], cfg["mn"], cfg["mx"],
                                 cfg["strict"])
        mode = "strict-reference" if strict else "component"
        gold_kinds = [k for k in PAIR_KINDS if not strict
                      or np.isfinite(golden_pair(k, mn, mx)).all()]
        gold = pool.submit(_oracle, "golden_pairs", imgs_np, sigma,
                           [golden_pair(k, mn, mx) for k in gold_kinds],
                           strict)
        cpu = pool.submit(_oracle, "cpu_pairs", imgs_np, sigma, mn, mx,
                          PAIR_KINDS, strict)
        for j, kind in enumerate(PAIR_KINDS):
            a, c = threshold_pair(kind, mn, mx, dev)
            # ---- K1's threshold mode, a frame and the batch ----
            plain = [Wn.frontend_nm(imgs[i], kern, (a, c)) for i in range(b)]
            for i in range(b):
                for got, want in zip(kfe.frontend(imgs[i], taps, (a, c)),
                                     plain[i]):
                    same("thr_k1", cfg, host(got), host(want))
            for got, want in zip(kfe.frontend(imgs, taps, (a, c)),
                                 zip(*plain)):
                same("thr_k1_batch", cfg, host(got),
                     host(torch.stack(want)))
            # ---- K2's NMS-map entry, K3 and K4, int16 and int32 maps ----
            for m in (nm_b, nm_b.to(torch.int32)):
                flood = torch.stack([P.hysteresis_packed(f, a, c,
                                                         strict=strict)
                                     for f in m])
                same("thr_k2_nm", cfg, host(khp.hysteresis_packed_nm(
                    m, a, c, strict=strict)), host(flood))
                same("thr_k2_nm_packed", cfg, host(khp.hysteresis_packed_nm(
                    m[0], a, c, strict=strict, packed_out=True)),
                    host(P.pack_mask(flood[0] > 0)))
                if strict:
                    continue       # K3 and K4 have no strict mode
                # with lo above hi the engines seed differently, as in JAX
                # (K4 keeps a strong pixel that is not weak): only K3 and K4
                # against their own plain versions then
                ordered = (threshold_bound(a, m.dtype)
                           <= threshold_bound(c, m.dtype))
                plain34 = (pool.submit(_oracle, "k34_pair", host(m[0]), kind,
                                       mn, mx)
                           if m.dtype == torch.int16 else None)
                for name, fn in (("k3", k3.hysteresis_dilate),
                                 ("k4", k4.hysteresis_banded)):
                    out = host(fn(m, a, c))
                    if ordered:
                        same(f"thr_{name}_flood", cfg, out, host(flood))
                    if plain34 is not None:
                        later(f"thr_{name}_plain", cfg, plain34,
                              lambda r, o=out[0], n=name: (r[n == "k4"], o))
            # ---- the functional entry points, each backend ----
            for backend in ("fused", "pallas", "xla"):
                one = host(canny_fn(imgs[0], a, c, kernel_vals=taps,
                                    backend=backend, hysteresis_mode=mode))
                many = host(canny_fn_batched(imgs, a, c, kernel_vals=taps,
                                             backend=backend,
                                             hysteresis_mode=mode))
                later(f"thr_canny_fn_{backend}", cfg, cpu,
                      lambda r, j=j, o=one: (r[j][0][0], o))
                later(f"thr_canny_fn_batched_{backend}", cfg, cpu,
                      lambda r, j=j, o=many: (r[j][0], o))
                if kind in gold_kinds:
                    g = gold_kinds.index(kind)
                    later(f"thr_golden_{backend}", cfg, gold,
                          lambda r, g=g, o=many: (r[g], o))
            packed = host(canny_fn_packed(imgs, a, c, kernel_vals=taps,
                                          hysteresis_mode=mode))
            later("thr_canny_fn_packed", cfg, cpu,
                  lambda r, j=j, o=packed: (r[j][1], o))
            # ---- the model classes truncate ----
            if kind not in MODEL_KINDS:
                continue
            for backend, model in models.items():
                # cpu_ref: (the batch's edges, its packed edges) at (mn, mx)
                for tag, got, pick in (
                        ("call", model(imgs[0], a, c), lambda r: r[0][0]),
                        ("batch", model.batch(imgs, a, c), lambda r: r[0]),
                        ("packed", model.packed(imgs[0], a, c),
                         lambda r: r[1][0]),
                        ("batch_packed", model.batch_packed(imgs, a, c),
                         lambda r: r[1])):
                    later(f"thr_model_{tag}_{backend}", cfg, cpu_ref,
                          lambda r, o=host(got), pick=pick: (pick(r), o))

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=ctx, initializer=_oracle_init) as pool:
        for cfg in cfgs["frames"] + cfgs.get("fixed", []):
            imgs_np = sweep_images(cfg)
            b, h, w = imgs_np.shape
            sigma, mn, mx, strict = (cfg["sigma"], cfg["mn"], cfg["mx"],
                                     cfg["strict"])
            mode = "strict-reference" if strict else "component"
            refs = {k: pool.submit(_oracle, k, imgs_np, sigma, mn, mx,
                                   strict) for k in ("golden", "cpu")}
            kern = gaussian_kernel(sigma)
            taps = torch.from_numpy(kern).to(dev)
            imgs = on_card(imgs_np)
            # ---- K1 ----
            nm_b = kfe.frontend(imgs, taps)
            masks_b = kfe.frontend(imgs, taps, (mn, mx))
            for i in range(b):
                ref = Wn.frontend_nm(imgs[i], kern)
                same("k1_nm", cfg, host(kfe.frontend(imgs[i], taps)),
                     host(ref.to(torch.int16)))
                for got, want in zip(kfe.frontend(imgs[i], taps, (mn, mx)),
                                     (ref >= mn, ref >= mx)):
                    same("k1_threshold", cfg, host(got),
                         host(P.pack_mask(want)))
                if b > 1:
                    same("k1_batch_nm", cfg, host(nm_b[i]),
                         host(ref.to(torch.int16)))
                    for got, want in zip(masks_b, (ref >= mn, ref >= mx)):
                        same("k1_batch_threshold", cfg, host(got[i]),
                             host(P.pack_mask(want)))
            # ---- K2: every frame's map, the extra map, the batch ----
            floods = [check_k2(cfg, f"frame {i}", nm_b[i], mn, mx, strict)
                      for i in range(b)]
            if b > 1:
                mode_k2 = "strict" if strict else "component"
                same(f"k2_batch_{mode_k2}", cfg, host(khp.hysteresis_packed(
                    *masks_b, h, w, strict=strict)), host(torch.stack(floods)))
                same(f"k2_batch_nm_int16_{mode_k2}", cfg,
                     host(khp.hysteresis_packed_nm(nm_b, mn, mx,
                                                   strict=strict)),
                     host(P.unpack_edges(torch.stack(floods), w)))
            extra = sweep_nm(cfg)
            if extra is not None:
                lo, hi = ENGINE_THRESHOLDS[cfg["nm"]]
                check_k2(cfg, cfg["nm"], on_card(extra), lo, hi, strict)
            # ---- K3 and K4 ----
            check_engines(cfg, "K1's maps", nm_b, mn, mx)
            if extra is not None:
                check_engines(cfg, cfg["nm"], on_card(extra)[None], lo, hi,
                              dilate=cfg["nm"] != "snake")
            # ---- the entry points, each backend ----
            outs, models = {}, {}
            for backend in ("fused", "pallas", "xla"):
                model = models[backend] = CannyTorch(
                    sigma, hysteresis_mode=mode, backend=backend, device=dev)
                outs[backend] = host(model.batch(imgs, mn, mx))
                same(f"batch_vs_frames_{backend}", cfg, outs[backend],
                     np.stack([host(model(imgs[i], mn, mx))
                               for i in range(b)]))
            packed = host(canny_fn_packed(imgs, mn, mx, kernel_vals=taps,
                                          hysteresis_mode=mode))
            sync()
            for backend, out in outs.items():
                later(f"cpu_{backend}", cfg, refs["cpu"],
                      lambda r, out=out: (r[0], out))
            later("cpu_canny_fn_packed", cfg, refs["cpu"],
                  lambda r, packed=packed: (r[1], packed))
            later("golden", cfg, refs["golden"],
                  lambda r, out=outs["fused"]: (r, out))
            if cfg in cfgs.get("fixed", []):     # sigma 0.1: every backend
                for backend in ("pallas", "xla"):
                    later(f"golden_{cfg['name']}_{backend}", cfg,
                          refs["golden"], lambda r, o=outs[backend]: (r, o))
            if cfg["name"] in cfgs.get("thresholds", ()):
                check_thresholds(cfg, imgs, imgs_np, nm_b, kern, taps,
                                 models, refs["cpu"])
        # ---- the sharded configurations ----
        engines, meshes, thr_engines = set(), set(), set()
        for cfg in cfgs["sharded"]:
            imgs_np = np.random.default_rng(cfg["img_seed"]).integers(
                0, 256, (cfg["batch"], cfg["h"], cfg["w"]), np.uint8)
            d, y, x = cfg["mesh"]
            mesh = make_mesh([dev] * (d * y * x), data=d, y=y, x=x)
            meshes.add(f"{d}x{y}x{x}")
            for strict in (False, True):
                mode = "strict-reference" if strict else "component"
                model = ShardedCanny(mesh, cfg["sigma"], (cfg["h"], cfg["w"]),
                                     hysteresis_mode=mode)
                engines.add(model.engine)
                out = host(model(imgs_np, cfg["mn"], cfg["mx"]))
                tag = f"sharded_{model.engine}_{mode.split('-')[0]}"
                same(tag, cfg, out, host(CannyTorch(
                    cfg["sigma"], hysteresis_mode=mode, device=dev).batch(
                        imgs_np, cfg["mn"], cfg["mx"])))
                if cfg["name"] in cfgs.get("thresholds", ()) and not strict:
                    thr_engines.add(model.engine)   # truncates, as JAX does
                    thr_ran.add(cfg["name"])
                    for kind in MODEL_KINDS:
                        same(f"thr_sharded_{model.engine}", cfg,
                             host(model(imgs_np, *threshold_pair(
                                 kind, cfg["mn"], cfg["mx"], dev))), out)
                later(f"{tag}_golden", cfg, pool.submit(
                    _oracle, "golden", imgs_np, cfg["sigma"], cfg["mn"],
                    cfg["mx"], strict), lambda r, out=out: (r, out))
        sync()
        sharded_launches = {"frontend_block": kfe.block_launches,
                            "hysteresis_packed_quirk": khp.quirk_launches}
        # ---- K1 on more frames than one launch takes ----
        if chunked:
            n, h, w = chunked
            distinct = np.random.default_rng(SWEEP_SEED).integers(
                0, 256, (251, h, w), np.uint8)
            pick = np.arange(n) % len(distinct)   # 251 is prime to 65535
            kern = gaussian_kernel(SIGMA)
            taps = torch.from_numpy(kern).to(dev)
            before = kfe.launches
            got = kfe.frontend(on_card(distinct[pick]), taps)
            chunk_launches = kfe.launches - before
            want = torch.stack([Wn.frontend_nm(on_card(f), kern)
                                for f in distinct]).to(torch.int16)
            same("k1_chunked", {"batch": n, "h": h, "w": w}, host(got),
                 host(want)[pick])
            check(chunk_launches == -(-n // kfe.MAX_BATCH),
                  f"K1 on {n} frames launched {chunk_launches} times")
        card_s = time.perf_counter() - t0
        for tag, cfg, fut, compare in pending:
            want, got = compare(fut.result())
            if isinstance(want, str):        # a count that did not hold
                mismatches.append({"case": tag, "config": cfg, "first": want})
                log(f"sweep MISMATCH {tag}: {want}, configuration {cfg}")
                continue
            same(tag, cfg, got, want)
    launches = {k: m.launches for k, m in mods.items()}
    launches.update({f"{k}_batch": m.batch_launches for k, m in mods.items()},
                    **sharded_launches)
    rep = {"cases": dict(sorted(cases.items())), "launches": launches,
           "threshold_cases": sum(v for k, v in cases.items()
                                  if k.startswith("thr_")),
           "threshold_kinds": list(PAIR_KINDS),
           "engines": sorted(engines), "meshes": sorted(meshes),
           "k4_band_h": bands, "mismatches": len(mismatches),
           "mismatch_list": mismatches[:50],
           "configurations": {k: len(v) for k, v in cfgs.items()},
           "card_s": card_s, "s": time.perf_counter() - t0}
    check(not mismatches, f"the sweep found {len(mismatches)} mismatches: "
          f"{mismatches[:5]}")
    check(engines == ({"static", "generic"} if cfgs["sharded"] else set()),
          f"sharded engines {engines}")
    want = {c["name"] for c in cfgs["frames"] + cfgs.get("fixed", [])
            + cfgs["sharded"]} & set(cfgs.get("thresholds", ()))
    check(thr_ran == want, f"threshold cases ran on {sorted(thr_ran)}, "
          f"not on {sorted(want - thr_ran)}")
    check(not any(c.startswith("sharded") for c in want)
          or thr_engines == {"static", "generic"},
          f"threshold cases on the sharded engines {thr_engines}")
    check(all(v for k, v in launches.items() if cfgs["sharded"]
              or k in mods), f"a kernel of the sweep never launched: "
          f"{launches}")
    return rep


# Phase 15: K1 at wide windows (its ring path on the H100 from 105 to 613
# taps, its scratch path past them) and K4 past the block-wide path's 32768
# columns
CAPACITY_SIGMAS = {263: 43.66, 265: 43.67, 301: 50.0, 601: 100.0,
                   701: 116.5}
# K1's window sweep at 1080p: device ms, bound and path by window
K1_SWEEP = (17, 19, 25, 31, 37, 49, 61, 121, 201, 263, 265, 301, 601)
CAPACITY_WIDTHS = ((130, 32768), (130, 32769), (96, 40000), (64, 131072),
                   (64, 524288))
CAP_MN, CAP_MX = 1, 3      # a 601-tap blur leaves steps of a few levels


def capacity_frame(h, w, seed=0):
    """The headline frame with a disc of 255 about its top-left corner and
    one of 0 about its bottom-right: edges that a blur of 601 taps still
    leaves (the headline frame alone keeps 20 NMS pixels at 1080p)."""
    img = make_image(h, w, seed=seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.hypot(xx, yy) < min(h, w) / 2] = 255
    img[np.hypot(xx - w, yy - h) < min(h, w) / 3] = 0
    return img


def capacity_phase(dev, time_ms, device_ms, hw=SIZES["1080p"],
                   odd=(257, 333), widths=CAPACITY_WIDTHS,
                   wide_frame=(96, 40000), sweep=K1_SWEEP):
    """Phase 15: every frame JAX computes, on the card.

    The slice's path, with the launch counts from 0 just before and read
    just after: ``CannyTorch`` (``fused``), ``canny_fn`` on ``pallas`` and
    ``ShardedCanny``'s static engine on an in-process 1x2x2 mesh at each
    window of ``CAPACITY_SIGMAS`` on a ``capacity_frame`` of ``hw``, and
    ``canny_fused(hysteresis_impl="banded")`` on a ``wide_frame``: K1's
    ring and scratch paths, in frame and block mode, and K4's wide path
    must run as ``kernels.frontend.k1_path`` chooses, and every result
    equals the plain pipeline on the card.  Then each kernel against its
    plain version on the card: K1 at each window in NMS and threshold mode
    at ``hw``, on a batch of 3 at ``odd`` and in block mode; ``canny_fn``
    on ``fused`` and ``pallas`` against the port's ``golden`` at ``odd``;
    K1 in threshold mode at each window of ``sweep``; K4 on a serpentine
    and a random map at each of ``widths``, edges and sweeps at the band
    that ran.  Times: K1 at ``hw`` at every window and K4 at each width, by
    CUDA events and torch.profiler, with the plain versions'.  0
    mismatches.  Returns ``(report, kernel entries of the kernels
    line)``."""
    import torch

    from canny_edge_tpu_torch import CannyTorch, golden
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
    from canny_edge_tpu_torch.kernels.fused import canny_fused
    from canny_edge_tpu_torch.models.canny import canny_fn
    from canny_edge_tpu_torch.ops import banded as Bd
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops import window as Wn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from canny_edge_tpu_torch.parallel import ShardedCanny, make_mesh
    from canny_edge_tpu_torch.utils.roofline import kernel_bounds

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def u32eq(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def plain_edges(img, kern, mn, mx):
        return P.hysteresis_packed(Wn.frontend_nm(img, kern), mn, mx)

    t0 = time.perf_counter()
    rep = {"mismatches": 0, "cases": 0}

    def expect(cond, what):
        rep["cases"] += 1
        if not cond:
            rep["mismatches"] += 1
            log(f"capacity mismatch: {what}")

    kerns = {win: gaussian_kernel(s) for win, s in CAPACITY_SIGMAS.items()}
    check(all(len(k) == win for win, k in kerns.items()),
          f"capacity windows {[len(k) for k in kerns.values()]}")
    frame = capacity_frame(*hw)
    img = torch.from_numpy(frame).to(dev)
    mesh = make_mesh([dev] * 4, y=2, x=2)
    wide_np = make_image(*wide_frame, seed=5)
    taps14 = torch.from_numpy(gaussian_kernel(SIGMA)).to(dev)

    # ---- the slice's path, counts from 0 ----
    shard = {win: ShardedCanny(mesh, s, hw) for win, s in
             CAPACITY_SIGMAS.items()}
    check(all(m.engine == "static" for m in shard.values()),
          "ShardedCanny at a capacity window is not on its static engine")
    for mod, names in ((kfe, ("launches", "block_launches", "ring_launches",
                              "scratch_launches")),
                       (khp, ("launches",)), (k4, ("launches",
                                                   "wide_launches"))):
        for n in names:
            setattr(mod, n, 0)
    plain_calls = dict(P.calls)
    outs = {}
    for win, s in CAPACITY_SIGMAS.items():
        outs["fused", win] = CannyTorch(s, device=dev)(frame, CAP_MN,
                                                       CAP_MX)
        outs["pallas", win] = canny_fn(img, CAP_MN, CAP_MX, backend="pallas",
                                       kernel_vals=kerns[win])
    outs["banded_wide"] = canny_fused(torch.from_numpy(wide_np).to(dev), MN,
                                      MX, kernel_vals=taps14,
                                      hysteresis_impl="banded")
    sync()
    # the plain pack and unpack calls of the single-card paths (the mesh's
    # glue unpacks each block's edges with the plain unpack, by design)
    plain_diff = {k: P.calls[k] - plain_calls[k] for k in P.calls}
    for win in CAPACITY_SIGMAS:
        outs["sharded", win] = shard[win](frame[None], CAP_MN, CAP_MX)[0]
    sync()
    counts = {"frontend": kfe.launches, "frontend_block": kfe.block_launches,
              "frontend_ring": kfe.ring_launches,
              "frontend_scratch": kfe.scratch_launches,
              "hysteresis_packed": khp.launches,
              "hysteresis_banded": k4.launches,
              "hysteresis_banded_wide": k4.wide_launches}
    log(f"capacity path launches: {counts}")
    if dev.type == "cuda":
        paths = [kfe.k1_path(win, kfe.max_window(dev))
                 for win in CAPACITY_SIGMAS]
        nwin = len(CAPACITY_SIGMAS)
        check(paths.count("ring") == 4 and paths.count("scratch") == 1
              and counts["frontend_ring"] == 6 * paths.count("ring")
              and counts["frontend_scratch"] == 6 * paths.count("scratch")
              and counts["frontend_block"] == 4 * nwin
              and counts["hysteresis_banded_wide"] == 1
              and counts["hysteresis_banded"] == 1,
              f"the capacity path launched {counts} on K1 paths {paths}: "
              f"want 6 launches of K1 a window (1 fused, 1 pallas, 4 blocks) "
              f"on the path the window takes, 4 windows on the ring path and "
              f"one past {kfe.max_window(dev)} taps on the scratch path, and "
              f"one wide K4")
        check(not any(plain_diff.values()),
              f"the capacity path called a plain pack/unpack: {plain_diff}")
    edge_px = {}
    for win in CAPACITY_SIGMAS:
        want = plain_edges(img, kerns[win], CAP_MN, CAP_MX)
        edge_px[win] = int((want == 255).sum())
        expect(edge_px[win] > 0, f"no edges at window {win}")
        for run in ("fused", "pallas", "sharded"):
            got = outs[run, win]
            expect(got.dtype == torch.int16 and torch.equal(got, want),
                   f"{run} at window {win} differs from the plain pipeline")
    want = plain_edges(torch.from_numpy(wide_np).to(dev), gaussian_kernel(SIGMA),
                       MN, MX)
    expect(torch.equal(outs["banded_wide"], want)
           and int((want == 255).sum()) > 0,
           f"banded at {wide_frame} differs from the plain pipeline")
    rep["path"] = {"launches": counts, "edge_px": edge_px,
                   "s": time.perf_counter() - t0}

    # ---- K1 at each window against its plain version ----
    t1 = time.perf_counter()
    k1_err, k1_times = 0, {}
    small = capacity_frame(*odd)
    batch = torch.from_numpy(np.stack([capacity_frame(*odd, seed=s)
                                       for s in range(3)])).to(dev)
    for win, kern in kerns.items():
        taps = torch.from_numpy(kern).to(dev)
        t = time.perf_counter()
        ref = Wn.frontend_nm(img, kern)
        sync()
        plain_ms = (time.perf_counter() - t) * 1e3
        nm = kfe.frontend(img, taps)
        weak, strong = kfe.frontend(img, taps, (CAP_MN, CAP_MX))
        sync()
        k1_err = max(k1_err, int((nm.to(torch.int32) - ref).abs().max()))
        expect(torch.equal(nm.to(torch.int32), ref),
               f"K1 nm at window {win}, {hw}")
        expect(u32eq(weak, P.pack_mask(ref >= CAP_MN))
               and u32eq(strong, P.pack_mask(ref >= CAP_MX)),
               f"K1 masks at window {win}, {hw}")
        bnm = kfe.frontend(batch, taps)
        bw, bs = kfe.frontend(batch, taps, (CAP_MN, CAP_MX))
        sync()
        for i in range(batch.shape[0]):
            r = Wn.frontend_nm(batch[i], kern)
            expect(torch.equal(bnm[i].to(torch.int32), r)
                   and u32eq(bw[i], P.pack_mask(r >= CAP_MN))
                   and u32eq(bs[i], P.pack_mask(r >= CAP_MX)),
                   f"K1 batch frame {i} at window {win}, {odd}")
        # block mode: an interior 1x2x2 block's window and the corner's
        r = win // 2 + 2
        pad = torch.nn.functional.pad(img, (r, r, r, r))
        for row0, col0, hl, wl in ((0, 0, hw[0] // 2, hw[1] // 2),
                                   (hw[0] // 4, hw[1] // 4, 300, 512)):
            win_u8 = pad[row0:row0 + hl + 2 * r, col0:col0 + wl + 2 * r]
            got = kfe.frontend_block(win_u8.contiguous(), row0, col0, *hw,
                                     taps)
            gotm = kfe.frontend_block(win_u8.contiguous(), row0, col0, *hw,
                                      taps, (CAP_MN, CAP_MX))
            refb = Wn.frontend_block(win_u8, row0, col0, *hw, kern)
            refm = Wn.frontend_block(win_u8, row0, col0, *hw, kern,
                                     (CAP_MN, CAP_MX))
            sync()
            expect(torch.equal(got.to(torch.int32), refb)
                   and all(u32eq(a, b) for a, b in zip(gotm, refm)),
                   f"K1 block ({row0}, {col0}) at window {win}")
        # canny_fn on both backends against golden on a small frame
        gold = golden.canny(small, CAPACITY_SIGMAS[win], CAP_MN, CAP_MX)
        expect((gold == 255).any(), f"golden has no edges at window {win}")
        for backend in ("fused", "pallas"):
            got = canny_fn(torch.from_numpy(small).to(dev), CAP_MN, CAP_MX,
                           backend=backend, kernel_vals=kern)
            expect(np.array_equal(got.cpu().numpy(), gold),
                   f"canny_fn {backend} at window {win} differs from golden")
        fn = (lambda taps=taps: kfe.frontend(img, taps, (CAP_MN, CAP_MX)))
        by = device_ms(fn)
        kb = kernel_bounds(hw=hw, window=win)["frontend"]
        k1_times[win] = {
            "path": kfe.k1_path(win, kfe.max_window(dev))
            if dev.type == "cuda" else "plain",
            "ms": time_ms(fn, 10, 3),
            "device_ms": sum(by.values()) if by else "not measured",
            "device_by_kernel": by, "plain_ms": plain_ms,
            "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"]}
    # the sweep's other windows: threshold mode against the plain version,
    # then the same times (a sigma of (window // 2 - 0.5) / 3 gives window)
    for win in sorted(set(sweep) - set(k1_times)):
        kern = gaussian_kernel((win // 2 - 0.5) / 3)
        check(len(kern) == win, f"sweep window {win}: {len(kern)} taps")
        taps = torch.from_numpy(kern).to(dev)
        t = time.perf_counter()
        ref = Wn.frontend_nm(img, kern)
        sync()
        plain_ms = (time.perf_counter() - t) * 1e3
        weak, strong = kfe.frontend(img, taps, (CAP_MN, CAP_MX))
        sync()
        expect(u32eq(weak, P.pack_mask(ref >= CAP_MN))
               and u32eq(strong, P.pack_mask(ref >= CAP_MX)),
               f"K1 masks at sweep window {win}, {hw}")
        fn = (lambda taps=taps: kfe.frontend(img, taps, (CAP_MN, CAP_MX)))
        by = device_ms(fn)
        kb = kernel_bounds(hw=hw, window=win)["frontend"]
        k1_times[win] = {
            "path": kfe.k1_path(win, kfe.max_window(dev))
            if dev.type == "cuda" else "plain",
            "ms": time_ms(fn, 10, 3),
            "device_ms": sum(by.values()) if by else "not measured",
            "device_by_kernel": by, "plain_ms": plain_ms,
            "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"]}
    k1_times = dict(sorted(k1_times.items()))
    rep["k1"] = {"times": k1_times, "max_abs_err": k1_err,
                 "s": time.perf_counter() - t1}
    log(f"capacity K1: {k1_times}")

    # ---- K4 at each width against its plain version ----
    t1 = time.perf_counter()
    rng = np.random.default_rng(15)
    k4_err, k4_times = 0, {}
    for h, w in widths:
        for kind in ("snake", "random"):
            nm = torch.from_numpy(snake_nm(h, w) if kind == "snake"
                                  else random_nm(rng, h, w)).to(dev)
            lo, hi = ENGINE_THRESHOLDS[kind]
            out, st = k4.banded_stats(nm, lo, hi)
            sync()
            t = time.perf_counter()
            ref, sweeps = Bd.hysteresis_banded(nm, lo, hi, band_h=st["band_h"],
                                               return_sweeps=True)
            sync()
            plain_ms = (time.perf_counter() - t) * 1e3
            k4_err = max(k4_err, int((out - ref).abs().max()) // 255)
            expect(torch.equal(out, ref) and st["sweeps"] == sweeps
                   and int((ref == 255).sum()) > 0,
                   f"K4 {kind} {h}x{w}: sweeps {st['sweeps']} against "
                   f"{sweeps}, band {st['band_h']}")
            if kind == "random":
                fn = (lambda nm=nm, lo=lo, hi=hi:
                      k4.hysteresis_banded(nm, lo, hi))
                by = device_ms(fn)
                kb = kernel_bounds(hw=(h, w))["hysteresis_banded"]
                k4_times[w] = {
                    "h": h, "band_h": st["band_h"], "sweeps": st["sweeps"],
                    "rounds_max": st.get("rounds_max"),
                    "path": k4.k4_plan(w, st["band_h"], True,
                                       torch.cuda.get_device_properties(
                                           dev).shared_memory_per_block_optin)
                    [0] if dev.type == "cuda" else "plain",
                    "ms": time_ms(fn, 5, 3),
                    "device_ms": sum(by.values()) if by else "not measured",
                    "device_by_kernel": by, "plain_ms": plain_ms,
                    "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"]}
    rep["k4"] = {"times": k4_times, "max_abs_err": k4_err,
                 "s": time.perf_counter() - t1}
    log(f"capacity K4: {k4_times}")
    rep["s"] = time.perf_counter() - t0
    check(rep["mismatches"] == 0,
          f"capacity: {rep['mismatches']} mismatches of {rep['cases']}")

    kb = kernel_bounds()
    t131 = k4_times[131072]

    def k1_entry(name, win):
        """The kernels line's entry of K1's ``name`` path at ``win`` taps,
        with its times at every window that took the path."""
        t = k1_times[win]
        on = {w: v for w, v in k1_times.items() if v["path"] == t["path"]}
        return {"name": name, "route": "cuda",
                "source": "canny_edge_tpu_torch/kernels/csrc/frontend.cu",
                "replaces": "canny_edge_tpu/kernels/frontend.py:153",
                "launches": counts[name], "max_abs_err": k1_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "of": "frontend", "window": win,
                "match": True, "shape": f"{hw[0]}x{hw[1]}, window {win}",
                "device_ms": t["device_ms"],
                "ms_by_window": {w: v["ms"] for w, v in on.items()},
                "device_ms_by_window": {w: v["device_ms"]
                                        for w, v in on.items()}}

    entries = [
        k1_entry("frontend_ring", 263),
        k1_entry("frontend_scratch", 701),
        {"name": "hysteresis_banded_wide", "route": "cuda",
         "source": "canny_edge_tpu_torch/kernels/csrc/hysteresis_banded.cu",
         "replaces": "canny_edge_tpu/kernels/hysteresis_v2.py:70",
         "launches": counts["hysteresis_banded_wide"],
         "max_abs_err": k4_err, "ms": t131["ms"],
         "plain_ms": t131["plain_ms"],
         "bound_ms": kb["hysteresis_banded_wide"]["bound_ms"],
         "bound_by": kb["hysteresis_banded_wide"]["bound_by"],
         "library_ms": None, "match": True,
         "shape": "64x131072 random NMS map",
         "device_ms": t131["device_ms"],
         "ms_by_width": {w: t["ms"] for w, t in k4_times.items()},
         "device_ms_by_width": {w: t["device_ms"]
                                for w, t in k4_times.items()}},
    ]
    return rep, entries


# Phase 16: a Sentinel-2 Level-1C 10 m band tile (10980x10980 uint16,
# reflectance x 10000, thresholds cam1080's 30/90 at that white level) and
# the same tile at the full uint16 range, whose squared gradients pass 2^24
S2_TILE = (10980, 10980)
S2_SCALES = ((10000, 1176, 3529), (65535, 7710, 23130))


def s2_tile(h, w, full, seed, dev):
    """A uint16 ``(h, w)`` tile at white level ``full``, made on ``dev``:
    the headline frame's sinusoid, disc and noise (``make_image``'s) scaled
    from 255 to ``full``, so the noise fills the low bits."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    img = 96 + 64 * torch.sin(xx / 17.0) * torch.cos(yy / 23.0)
    img = img + 80 * (((xx - w / 2) ** 2 + (yy - h / 2) ** 2)
                      < (min(h, w) / 3) ** 2)
    img = img + 6 * torch.randn((h, w), generator=g, device=dev)
    return (img.clamp(0, 255) * (full / 255)).round().to(
        torch.int32).to(torch.uint16)


def uint16_phase(dev, time_ms, device_ms, hw=S2_TILE, scales=S2_SCALES,
                 seed=2200000601):
    """Phase 16: uint16 frames on the main path.  At each white level of
    ``scales``, a tile of ``hw`` (:func:`s2_tile`) through
    ``CannyTorch(1.4)``'s ``fused`` backend on the card, with K1's and
    K2's launch counts and ``u16_frames`` set to 0 just before and read
    just after (one launch of each, one uint16 frame, through a launch
    plan), held bit for bit against the plain PyTorch pipeline of
    ``portbench/reference/plain_torch.py`` on the card; K1's uint16
    instantiation alone, its packed masks against that pipeline's NMS map,
    timed by CUDA events and torch.profiler beside its bound
    (``kernel_bounds``' ``frontend_u16``, 2 bytes a pixel and 4 window + 45
    operations).  Returns ``(report, kernel entries of the kernels
    line)``."""
    import torch

    from canny_edge_tpu_torch import CannyTorch
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.kernels import plan as kplan
    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from canny_edge_tpu_torch.utils.roofline import kernel_bounds
    from portbench.reference import plain_torch as PT

    t0 = time.perf_counter()
    h, w = hw
    model = CannyTorch(SIGMA)
    taps = torch.from_numpy(gaussian_kernel(SIGMA)).to(dev)
    rep = {"shape": f"{h}x{w}", "scales": {}}
    k1_err = 0
    for full, mn, mx in scales:
        tile = s2_tile(h, w, full, seed + full, dev)
        torch.cuda.synchronize()
        kfe.launches = kfe.u16_frames = khp.launches = 0
        planned = kplan.plan_builds + kplan.plan_hits
        out = model(tile, mn, mx)
        torch.cuda.synchronize()
        counts = {"frontend": kfe.launches, "u16_frames": kfe.u16_frames,
                  "hysteresis_packed": khp.launches,
                  "plans": kplan.plan_builds + kplan.plan_hits - planned}
        check(counts == {"frontend": 1, "u16_frames": 1,
                         "hysteresis_packed": 1, "plans": 1},
              f"uint16 tile at {full}: counts {counts}")
        t = time.perf_counter()
        with PT.no_tf32():
            s = PT.blur(tile, SIGMA)
            gx, gy = PT.gradients(s)
            del s
            top = int((gx * gx + gy * gy).max())
            nm = PT.nonmax(gx, gy, PT.magnitude(gx, gy))
            del gx, gy
            ref = PT.hysteresis(nm, mn, mx)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        bad = int((out != ref).sum())
        edges = int((ref == 255).sum())
        check(bad == 0 and edges > 0,
              f"uint16 tile at {full}: {bad} pixels differ from plain_torch "
              f"({edges} edge pixels)")
        weak, strong = kfe.frontend(tile, taps, (mn, mx))
        torch.cuda.synchronize()
        i32 = torch.int32
        mask_bad = int((weak.view(i32) != P.pack_mask(nm >= mn).view(i32))
                       .sum() + (strong.view(i32)
                                 != P.pack_mask(nm >= mx).view(i32)).sum())
        k1_err = max(k1_err, mask_bad)
        check(mask_bad == 0, f"uint16 tile at {full}: K1's masks differ from "
                             f"plain_torch's NMS map in {mask_bad} words")
        del nm, ref, out, weak, strong
        k1 = (lambda tile=tile, mn=mn, mx=mx:
              kfe.frontend(tile, taps, (mn, mx)))
        by = device_ms(k1)
        kb = kernel_bounds(tile=hw)["frontend_u16"]
        rep["scales"][full] = {
            "thresholds": [mn, mx], "edge_px": edges, "mismatched_px": bad,
            "max_sq_gradient": top, "launches": counts,
            "k1_ms": time_ms(k1, 5, 5),
            "k1_device_ms": sum(by.values()) if by else "not measured",
            "k1_device_by_kernel": by,
            "frame_ms": time_ms(lambda tile=tile, mn=mn, mx=mx:
                                model(tile, mn, mx), 5, 5),
            "plain_ms": plain_ms, "bound_ms": kb["bound_ms"],
            "bound_by": kb["bound_by"]}
        log(f"uint16 tile at {full}: {rep['scales'][full]}")
        del tile
    check(rep["scales"][scales[-1][0]]["max_sq_gradient"] >= 1 << 24,
          "the full-range tile's squared gradients stay below 2^24")
    rep["s"] = time.perf_counter() - t0
    t = rep["scales"][scales[0][0]]
    entry = {"name": "frontend_u16", "route": "cuda",
             "source": "canny_edge_tpu_torch/kernels/csrc/frontend.cu",
             "replaces": "canny_edge_tpu/kernels/frontend.py:153",
             "launches": t["launches"]["frontend"], "max_abs_err": k1_err,
             "ms": t["k1_ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": None, "match": True,
             "shape": f"{h}x{w} uint16, full scale {scales[0][0]}",
             "device_ms": t["k1_device_ms"],
             "ms_by_scale": {f: v["k1_ms"] for f, v in rep["scales"].items()},
             "frame_ms_by_scale": {f: v["frame_ms"]
                                   for f, v in rep["scales"].items()}}
    return rep, [entry]


def check_bounds(kernels):
    """Every ``bound_ms`` of the ``kernels`` line is
    ``utils.roofline.kernel_bounds``': a batch row's (``"batch"``) that of
    its single-frame kernel (``"of"``) at its batch, a row of one of K1's
    wide paths that of ``"of"`` at its ``"window"``."""
    from canny_edge_tpu_torch.utils.roofline import kernel_bounds

    for k in kernels:
        want = kernel_bounds(window=k.get("window", 11), batch=k.get(
            "batch"))[k.get("of", k["name"])]
        check(k["bound_ms"] == want["bound_ms"]
              and k["bound_by"] == want["bound_by"],
              f"{k['name']} bound {k['bound_ms']} {k['bound_by']}, "
              f"kernel_bounds {want}")


def bench_phase(kernels, samples=3, hw=SIZES["1080p"]):
    """Phase 12: ``bench_torch.measure`` in this process at ``samples``
    samples a backend.  Checks that every backend gives MP/s, that the best
    backend's roofline has a ``frontend`` and a ``hysteresis`` row, each at
    0 < pct_of_sol <= 105 of a named bound, that the front end's audited
    ``alu`` count is that of a front end (50 to 400 a pixel), and that
    every ``bound_ms`` of the ``kernels`` line is
    ``utils.roofline.kernel_bounds``'.  Returns the bench's record."""
    import bench_torch
    from canny_edge_tpu_torch.utils.roofline import kernel_bounds

    t0 = time.perf_counter()
    rec = bench_torch.measure(samples=samples, hw=hw)
    for b in bench_torch.BACKENDS:
        check(rec["backends"][b]["mp_per_s"] > 0,
              f"bench: backend {b} gave {rec['backends'][b]}")
    rows = {r["stage"]: r for r in rec["roofline"]}
    check(set(rows) == {"frontend", "hysteresis"},
          f"bench: the {rec['best_backend']} roofline has rows {list(rows)}")
    for r in rows.values():
        check(r["pct_of_sol"] is not None and 0 < r["pct_of_sol"] <= 105
              and r["bound"] in ("alu", "hbm"), f"bench: roofline row {r}")
    alu = rows["frontend"]["audit"]["alu"]
    check(50 <= alu <= 400, f"bench: the front end's audited alu is {alu} "
          f"a pixel")
    check_bounds(kernels)
    check(kernels[1]["nm_int16_bound_ms"]
          == kernel_bounds()["hysteresis_packed_nm_int16"]["bound_ms"],
          "bench: K2's NMS-map bound differs from kernel_bounds")
    rec["s"] = time.perf_counter() - t0
    return rec


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
    from canny_edge_tpu_torch.utils.roofline import kernel_bounds

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
    # one launch of each stage a call: __call__, packed and the batch
    want = 3 * len(models) * len(frames)
    check(counts == {"frontend": want, "hysteresis_packed": want},
          f"the main path launched {counts}, not {want} of each kernel")
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
        # each input byte read once, each output byte written once, the hand
        # model's operations (utils/roofline.py:kernel_bounds)
        kb = kernel_bounds(hw=(h, w), window=len(kern))
        for k, key in (("k1", "frontend"), ("k2", "hysteresis_packed"),
                       ("k2_nm_int16", "hysteresis_packed_nm_int16")):
            t[f"{k}_bound_ms"] = kb[key]["bound_ms"]
            t[f"{k}_bound_by"] = kb[key]["bound_by"]
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
        # K3 and K4: nm read once (2 B/px), int16 edges written once (2 B/px)
        kb = kernel_bounds(hw=(h, w))
        for k, key in (("k3", "hysteresis_dilate"),
                       ("k4", "hysteresis_banded")):
            t[f"{k}_bound_ms"] = kb[key]["bound_ms"]
            t[f"{k}_bound_by"] = kb[key]["bound_by"]
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
         "device_ms": kt["k1_block_device_ms"],
         "audited_alu_per_px": kt["k1_block_audited_alu_per_px"],
         "audited_floor_ms": kt["k1_block_audited_floor_ms"]},
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
         "device_ms": kt["k2_quirk_device_ms"], "steps": kt["k2_quirk_steps"],
         "audited_alu_per_px": kt["k2_quirk_audited_alu_per_px"],
         "audited_floor_ms": kt["k2_quirk_audited_floor_ms"]},
    ]
    report["kernels"] = kernels

    # ---- 12. the port's headline bench, in this process ----
    bench = bench_phase(kernels)
    report["bench"] = bench

    # ---- 13. the batch path ----
    report["batch_path"], batch_kernels = batch_phase(dev, time_ms, host_ms,
                                                      device_ms)
    check_bounds(batch_kernels)
    kernels += batch_kernels
    bt = report["batch_path"]["times"]
    print("batch: " + json.dumps({
        "card": card, "launches": report["batch_path"]["launches"],
        "sweeps": report["batch_path"]["sweeps"],
        "times": {size: {k: v for k, v in t.items()
                         if k.endswith("_ms") or k == "frames"}
                  for size, t in bt.items()},
        "s": report["batch_path"]["s"]}), flush=True)
    # ---- 14. the seeded sweep ----
    report["sweep"] = sweep_phase(dev)
    sw = report["sweep"]
    print("sweep: " + json.dumps({
        "card": card, "configurations": sw["configurations"],
        "cases": sw["cases"], "launches": sw["launches"],
        "engines": sw["engines"], "meshes": sw["meshes"],
        "threshold_cases": sw["threshold_cases"],
        "threshold_kinds": sw["threshold_kinds"],
        "mismatches": sw["mismatches"],
        "s": sw["s"]}), flush=True)
    # ---- 15. capacity: K1 past its tile path, K4 past 32768 columns ----
    report["capacity"], cap_kernels = capacity_phase(dev, time_ms, device_ms)
    check_bounds(cap_kernels)
    kernels += cap_kernels
    cap = report["capacity"]
    print("capacity: " + json.dumps({
        "card": card, "launches": cap["path"]["launches"],
        "cases": cap["cases"], "mismatches": cap["mismatches"],
        "k1_by_window": {w: {k: t[k] for k in ("path", "ms", "device_ms",
                                               "plain_ms", "bound_ms")}
                         for w, t in cap["k1"]["times"].items()},
        "k4_by_width": {w: {k: t[k] for k in ("h", "path", "band_h",
                                              "sweeps", "ms", "device_ms",
                                              "plain_ms", "bound_ms")}
                        for w, t in cap["k4"]["times"].items()},
        "s": cap["s"]}), flush=True)
    # ---- 16. uint16: a Sentinel-2 tile through the fused path ----
    report["uint16"], u16_kernels = uint16_phase(dev, time_ms, device_ms)
    check_bounds(u16_kernels)
    kernels += u16_kernels
    print("uint16: " + json.dumps({"card": card, **report["uint16"]}),
          flush=True)
    report["total_s"] = time.perf_counter() - t_run
    log("report: " + json.dumps(report))
    out_dir = os.path.join(ROOT, "chiprun_out")     # listed in .gitignore
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    roofline = {b: [{k: r[k] for k in (
        "stage", "ms", "sol_ms", "pct_of_sol", "bound", "floor_model",
        "est_ops_per_px")} | {"audited_alu": (r["audit"] or {}).get("alu")}
        for r in rows] for b, rows in bench["roofline_by_backend"].items()}
    print("bench: " + json.dumps({
        "card": bench["card"], "metric": bench["metric"],
        "value": bench["value"], "best_backend": bench["best_backend"],
        "backends": {b: {k: v[k] for k in ("mp_per_s", "ms_median",
                                          "device_ms", "frontend_device_ms")}
                     for b, v in bench["backends"].items()},
        "roofline": roofline, "s": bench["s"]}), flush=True)
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
