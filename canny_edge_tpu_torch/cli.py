"""Command line of the port: the counterpart of ``canny_edge_tpu/cli.py``
(``canny-tpu``) and of the reference's ``./main sigma minVal maxVal [-s]``
(src/main.cpp:18-76), on an NVIDIA GPU.

Frames come from an image, a directory, a video, ``raw8:PATH:HxW[xN]`` or
``synthetic:HxW[xN]``; they are batched and staged onto the card ahead of
compute; each frame runs through the model (default ``fused``: K1 then K2)
and is written as a PNG; a cursor allows a resume; ``-s`` writes the stage
images and ``--time`` prints a table of the stages.  ``--device cpu`` runs
the plain PyTorch versions; without a card and without it the command exits
with an error (``golden`` always runs on the CPU).  ``--backend sharded``
runs :class:`.parallel.ShardedCanny` over a ``--mesh DATAxYxX`` of this
process's device (one block by default; a mesh of more blocks than devices
is refused, as JAX's ``make_mesh`` refuses it).

Examples::

    python -m canny_edge_tpu_torch.cli in.png 1.0 50 150 -o edges.png
    python -m canny_edge_tpu_torch.cli synthetic:1080x1920x64 1.4 30 90 \\
        --batch 8 --out-dir out/ --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="canny-torch",
        description="Canny edge detection on an NVIDIA GPU (PyTorch/CUDA)",
        epilog="sigma: stddev of the Gaussian blur kernel; "
               "minVal/maxVal: hysteresis thresholds in [0,255]",
    )
    p.add_argument("input", help="image/video path, directory, camera index, "
                                 "raw8:PATH:HxW[xN] or synthetic:HxW[xN]")
    p.add_argument("sigma", type=float, help="Gaussian sigma")
    p.add_argument("min_val", type=int, metavar="minVal",
                   help="minimum hysteresis threshold [0,255]")
    p.add_argument("max_val", type=int, metavar="maxVal",
                   help="maximum hysteresis threshold [0,255]")
    p.add_argument("-s", "--save-steps", action="store_true",
                   help="save per-stage intermediate images (the reference's"
                        " -s display)")
    p.add_argument("-o", "--output", default=None,
                   help="output path for a single image input")
    p.add_argument("--out-dir", default="canny_out",
                   help="output directory for multi-frame inputs / steps")
    p.add_argument("--backend", default="fused",
                   choices=["fused", "xla", "pallas", "sharded", "golden"],
                   help="execution backend (default: fused, K1 then K2; "
                        "golden: the unpacked stage path on the CPU)")
    p.add_argument("--hysteresis", default="component",
                   choices=["component", "strict-reference"],
                   help="hysteresis rule: clean 8-connected components, or "
                        "the reference binary's BFS including its bounds "
                        "quirk (src/utils.cpp:378,399)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: cuda; cpu runs the "
                        "plain PyTorch versions)")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per device batch")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--mesh", default=None,
                   help="sharded mesh as DATAxYxX, e.g. 1x2x4")
    p.add_argument("--prefetch", type=int, default=2,
                   help="device prefetch depth: batches staged onto the "
                        "device ahead of compute")
    p.add_argument("--resume", action="store_true",
                   help="resume from the stream cursor in --out-dir, "
                        "skipping batches a previous (killed) run completed")
    p.add_argument("--native-feeder", action="store_true",
                   help="source frames through the C++ ring-buffer feeder "
                        "(synthetic: inputs and frame_%%06d.pgm directories; "
                        "falls back to the Python source if the native "
                        "library is unavailable)")
    p.add_argument("--packed-transfer", action="store_true",
                   help="return bit-packed edge masks from the device and "
                        "expand them on the host (16x less device->host "
                        "traffic)")
    p.add_argument("--time", action="store_true", dest="timeit",
                   help="print per-stage timing (reference's Execution time"
                        " print, structured)")
    p.add_argument("--json", action="store_true",
                   help="emit machine-readable stats on stdout")
    return p


def validate_args(args) -> None:
    # mirrors src/main.cpp:63-76 (with real exit codes instead of exit(0))
    if args.max_val <= args.min_val:
        raise SystemExit("ERROR: minVal must be less than maxVal")
    if not (0 <= args.min_val <= 255):
        raise SystemExit("ERROR: minVal must be in the range of [0,255]")
    if not (0 <= args.max_val <= 255):
        raise SystemExit("ERROR: maxVal must be in the range of [0,255]")
    if args.sigma <= 0:
        raise SystemExit("ERROR: sigma must be positive")
    if args.packed_transfer and args.backend in ("golden", "sharded"):
        raise SystemExit("ERROR: --packed-transfer uses the single-chip "
                         "packed engines; use backend fused, xla, or pallas")


def open_frames(args, feeder_stats: dict | None = None):
    """Frame iterator for the input spec.

    Everything :func:`.io.video.open_source` opens, plus ``raw8:PATH:HxW[xN]``
    (headerless uint8 frames read by the native feeder) and, with
    ``--native-feeder``, synthetic sources and ``frame_%06d.pgm``
    directories through the feeder.  ``feeder_stats`` receives the feeder's
    final counters (produced/consumed/waits/read_errors) when the stream
    ends: a corrupt frame ends the producer loop, and only ``read_errors``
    tells that truncation from a complete stream.
    """
    from . import runtime
    from .io import video

    spec = args.input
    if spec.startswith("raw8:"):
        if not runtime.available():
            raise SystemExit("ERROR: raw8 input needs the native feeder "
                             "(C++ toolchain unavailable)")
        _, path, dims = spec.split(":", 2)
        h, w, n = video.parse_dims(dims)
        n = n or 0
        if args.max_frames is not None:
            n = min(n, args.max_frames) if n else args.max_frames
        return _feeder_frames(runtime.FrameFeeder(
            h, w, mode=runtime.MODE_RAW8, path=path, count=n), feeder_stats)
    if spec.startswith("synthetic:") and args.native_feeder \
            and runtime.available():
        h, w, n = video.parse_dims(spec.split(":", 1)[1])
        n = 1 if n is None else n
        if args.max_frames is not None:
            n = min(n, args.max_frames)
        return _feeder_frames(runtime.FrameFeeder(
            h, w, mode=runtime.MODE_SYNTHETIC, count=n), feeder_stats)
    if os.path.isdir(spec) and args.native_feeder:
        # the feeder reads the frame_%06d.pgm convention; other layouts
        # take the Python source below
        first_pgm = os.path.join(spec, "frame_000000.pgm")
        if os.path.exists(first_pgm) and runtime.available():
            from .io.imageio import load_grayscale

            h, w = load_grayscale(first_pgm).shape
            return _feeder_frames(runtime.FrameFeeder(
                h, w, mode=runtime.MODE_PGM_DIR, path=spec,
                count=args.max_frames or 0), feeder_stats)
    return video.open_source(spec, args.max_frames)


def _feeder_frames(feeder, stats_sink: dict | None = None):
    """Iterate a FrameFeeder, copying each zero-copy view (valid only until
    the next acquire, while batching and prefetch keep frames longer); the
    final counters go to ``stats_sink`` before the feeder is destroyed."""
    with feeder:
        try:
            for frame in feeder:
                yield frame.copy()
        finally:
            if stats_sink is not None:
                stats_sink.update(feeder.stats())


def build_config(args):
    """The one config object, built from argv."""
    from .config import CannyConfig

    mesh_d = mesh_y = mesh_x = 1
    if args.mesh:
        mesh_d, mesh_y, mesh_x = (int(v) for v in args.mesh.split("x"))
    cursor_path = (os.path.join(args.out_dir, ".canny_cursor.json")
                   if args.resume else None)
    try:
        return CannyConfig(
            sigma=args.sigma, min_val=args.min_val, max_val=args.max_val,
            backend=args.backend, hysteresis_mode=args.hysteresis,
            batch_size=args.batch, mesh_data=mesh_d, mesh_y=mesh_y,
            mesh_x=mesh_x, prefetch_depth=args.prefetch,
            checkpoint_path=cursor_path,
            packed_transfer=args.packed_transfer)
    except ValueError as e:
        raise SystemExit(f"ERROR: {e}")


def _make_run_batch(cfg, device, first_frame):
    """``(run_batch, device_put)`` for the StreamingRunner; a ``device_put``
    of None stages batches onto ``device``."""
    if cfg.backend == "golden":
        import torch

        from .ops import stages

        def run_batch(batch):
            outs = []
            for f in batch:
                sm = stages.gaussian_blur(torch.from_numpy(f), cfg.sigma)
                nm = stages.nonmax_suppression(*stages.sobel(sm))
                outs.append(stages.hysteresis(
                    nm, cfg.min_val, cfg.max_val,
                    mode=cfg.hysteresis_mode).numpy())
            return np.stack(outs)

        return run_batch, lambda b: b
    if cfg.backend == "sharded":
        from .parallel import ShardedCanny, make_mesh

        devices = [device]            # the process's one device, as JAX's
        try:
            if (cfg.mesh_data, cfg.mesh_y, cfg.mesh_x) != (1, 1, 1):
                mesh = make_mesh(devices, data=cfg.mesh_data, y=cfg.mesh_y,
                                 x=cfg.mesh_x)
            else:
                mesh = make_mesh(devices)
        except ValueError as e:
            raise SystemExit(f"ERROR: {e}")
        ndata = mesh.shape["data"]
        if cfg.batch_size % ndata:
            raise SystemExit(f"ERROR: --batch {cfg.batch_size} must be a "
                             f"multiple of the mesh data axis ({ndata})")
        model = ShardedCanny(mesh, cfg.sigma, first_frame.shape,
                             hysteresis_mode=cfg.hysteresis_mode)
        return (lambda b: model(b, cfg.min_val, cfg.max_val),
                model.shard_batch)
    from .models import CannyTorch

    model = CannyTorch(sigma=cfg.sigma, backend=cfg.backend,
                       hysteresis_mode=cfg.hysteresis_mode, device=device)
    if cfg.packed_transfer:
        # the device returns (B, H, ceil(W/32)) uint32 bitmasks; the writer
        # expands them on the host (ops.packed.unpack_edges_np)
        def run_batch(batch):
            if batch.shape[0] == 1:
                return model.packed(batch[0], cfg.min_val, cfg.max_val)[None]
            return model.batch_packed(batch, cfg.min_val, cfg.max_val)

        return run_batch, None

    def run_batch(batch):
        if batch.shape[0] == 1:
            return model(batch[0], cfg.min_val, cfg.max_val)[None]
        return model.batch(batch, cfg.min_val, cfg.max_val)

    return run_batch, None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    validate_args(args)
    cfg = build_config(args)
    from .kernels.fused import resolve_device

    try:            # without a card: the model's message, no silent CPU run
        # golden is the stage path on the CPU, whatever --device says
        device = resolve_device("cpu" if args.backend == "golden"
                                else args.device)
    except RuntimeError as e:
        raise SystemExit(f"ERROR: {e}")

    from .io import imageio, video
    from .parallel.streaming import StreamCursor, StreamingRunner

    feeder_stats: dict = {}
    try:
        frames = open_frames(args, feeder_stats)
        first = next(iter(frames))
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"ERROR: {e}")
    except StopIteration:
        raise SystemExit("ERROR: input source produced no frames")
    frames = _chain_first(first, frames)

    run_batch, device_put = _make_run_batch(cfg, device, first)

    single_image = (os.path.splitext(args.input)[1].lower()
                    in video.IMAGE_EXTS and args.output)
    saved_steps = [False]

    def on_result(bi, edges):
        if cfg.packed_transfer:
            from .ops.packed import unpack_edges_np

            edges = unpack_edges_np(edges, first.shape[-1])
        for fi in range(edges.shape[0]):
            if single_image:
                out_path = args.output
            else:
                idx = bi * cfg.batch_size + fi
                out_path = os.path.join(args.out_dir,
                                        f"edges_{idx:06d}.png")
            imageio.save_png(out_path, edges[fi].astype(np.uint8))
        if args.save_steps and not saved_steps[0]:
            saved_steps[0] = True
            _save_steps(args, first, device)

    if cfg.checkpoint_path:
        os.makedirs(args.out_dir, exist_ok=True)
    runner = StreamingRunner(
        run_batch, batch_size=cfg.batch_size,
        prefetch_depth=cfg.prefetch_depth,
        cursor=StreamCursor(cfg.checkpoint_path),
        device_put=device_put, device=device)
    t0 = time.perf_counter()
    rstats = runner.run(frames, on_result=on_result)
    elapsed = time.perf_counter() - t0

    stats = {
        "backend": cfg.backend,
        "config": cfg.to_dict(),
        "seconds": round(elapsed, 4),
        **rstats.to_dict(),
    }
    if feeder_stats:
        stats["feeder"] = feeder_stats
    report = None
    if args.timeit:
        from .utils.timing import profile_stages

        # the first input frame at its own size, marginal-prefix slopes
        report = profile_stages(first, cfg.sigma, cfg.min_val, cfg.max_val,
                                device=device)
        stats["stages"] = report.json()
    read_errors = int(feeder_stats.get("read_errors", 0))
    if args.json:
        print(json.dumps(stats))
    else:
        # the reference prints "Execution time: <s> seconds" (utils.cpp:489)
        print(f"Execution time: {elapsed:.6f} seconds "
              f"({stats['frames']} frames, {stats['mp_per_s']} MP/s"
              + (f", {stats['skipped_batches']} batches resumed-past"
                 if stats["skipped_batches"] else "") + ")")
    if report is not None:
        print(report.table(), file=sys.stderr)
    if read_errors:
        # a corrupt frame ends the producer loop: the stream is truncated,
        # not complete, so the run fails loudly
        print(f"ERROR: frame source ended early: {read_errors} unreadable "
              f"frame(s) after {stats['frames']} decoded", file=sys.stderr)
        return 3
    return 0


def _chain_first(first, rest):
    yield first
    yield from rest


def _save_steps(args, frame, device) -> None:
    """Save min-max normalized stage images (the reference's ``-s``): the
    stage path on ``device``, on the CPU for the ``golden`` backend."""
    from .io import imageio
    from .models import CannyTorch

    model = CannyTorch(sigma=args.sigma, device=(
        "cpu" if args.backend == "golden" else device))
    _, inter = model.with_intermediates(frame, args.min_val, args.max_val)
    os.makedirs(args.out_dir, exist_ok=True)
    for name in ("smoothed", "magnitude", "nonmax"):
        imageio.save_png(os.path.join(args.out_dir, f"step_{name}.png"),
                         imageio.minmax_normalize_u8(inter[name].cpu().numpy()))


if __name__ == "__main__":
    sys.exit(main())
