"""Spatially partitioned Canny over a ("data", "y", "x") mesh of blocks.

The counterpart of ``canny_edge_tpu/parallel/sharded.py``.  A batch
``(B, H, W)`` is zero-padded to the block grid and cut into blocks ``(B /
data, hl, wl)``; every stage runs on the blocks this process holds, with
halos from the neighbours (:mod:`.halo`) and the reference's border rules
applied at the true image border only, so the result is bit-equal to the
single-device path and the golden model on any mesh.  Two engines, chosen
as JAX chooses them (``ShardedCanny.engine``):

* **static**: a halo of ``r = window // 2 + 2`` texels, then K1 in block mode
  (``kernels/frontend.py:frontend_block``) at the offsets of the block's
  border class, which emits the packed weak/strong masks of the block; then
  the distributed packed flood: a halo of one word column and one row a
  round, the local fixed point of the extended block (K2 on the card, with
  the strict fix at row 1, word 1 of the top-left block), and a global count
  of changed words, read on the host, as the termination test.  A 1x1
  spatial mesh runs K2 once a frame, with no round loop.
* **generic**: the fallback where the class analysis does not hold; masked
  blur, Sobel and NMS stages and the unpacked dilation with a halo of
  ``hysteresis_steps``, in plain PyTorch (XLA outside any kernel in JAX).

The mesh a caller asks for is the mesh that runs: a mesh of several blocks
over one card is several blocks, each launching its own kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.frontend import frontend_block
from ..kernels.fused import resolve_device
from ..kernels.hysteresis_packed import hysteresis_packed
from ..ops.gaussian import gaussian_kernel
from ..ops.packed import cdiv, hysteresis_packed_masks, unpack_edges
from ..ops.shifts import shift_cols, shift_rows
from ..ops.stages import quantize_angle
from ..ops.window import NMS_OOB, count_vector, isqrt
from .halo import (DATA_AXIS, X_AXIS, Y_AXIS, Mesh, halo_exchange_2d,
                   halo_exchange_cols, halo_exchange_rows)

EDGE = 255
NOEDGE = 0
# dilations a round of the plain packed flood (canny_edge_tpu/utils/
# constants.py:INNER_DILATE_XLA); it changes the rounds, never the result
INNER_DILATE_XLA = 4

__all__ = ["DATA_AXIS", "Y_AXIS", "X_AXIS", "Mesh", "ShardedBatch",
           "ShardedCanny", "make_mesh"]


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------

def make_mesh(devices=None, data: int | None = None, y: int | None = None,
              x: int | None = None) -> Mesh:
    """Build a ("data", "y", "x") mesh.

    ``devices``: the devices of this process's blocks; None is this
    process's one device (the card).  With a ``torch.distributed`` process
    group every rank passes the same number of devices and the mesh has that
    many blocks a rank, rank-major, as JAX orders ``jax.devices()`` by
    process; with none, every block lives here (a list that repeats one
    device is a mesh of several blocks on it).  With no shape, the blocks
    are factored into the most square spatial grid with no data axis.
    """
    import torch.distributed as dist

    group = dist.is_available() and dist.is_initialized()
    if devices is None:
        if group and dist.get_backend() != "nccl":
            devices = [torch.device("cpu")]
        elif group:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [resolve_device("cuda")]
    local = [_indexed(torch.device(d)) for d in devices]
    world = dist.get_world_size() if group else 1
    n = world * len(local)
    if data is None and y is None and x is None:
        data = 1
        y, x = _factor2(n)
    data = data or 1
    if y is None and x is None:
        y, x = _factor2(n // data)
    y = y or (n // (data * (x or 1)))
    x = x or (n // (data * y))
    if data * y * x != n:
        raise ValueError(f"mesh {data}x{y}x{x} != {n} devices")
    devs = np.empty(n, dtype=object)
    for k in range(n):
        devs[k] = local[k % len(local)]
    ranks = np.arange(n) // len(local) if group else None
    return Mesh(devs.reshape(data, y, x),
                None if ranks is None else ranks.reshape(data, y, x))


def _indexed(dev: torch.device) -> torch.device:
    """A card named without an index is the current one."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _factor2(n: int) -> tuple[int, int]:
    """Factor n into the most-square (y, x) pair."""
    best = (1, n)
    for y in range(1, int(np.sqrt(n)) + 1):
        if n % y == 0:
            best = (y, n // y)
    return best


# ---------------------------------------------------------------------------
# blocks of a batch
# ---------------------------------------------------------------------------

class ShardedBatch:
    """The blocks of a ``(B, Hp, Wp)`` batch that this process holds:
    ``blocks[(d, y, x)]`` is ``(B / data, hl, wl)`` on the block's device.
    ``hw`` is the image's ``(H, W)`` inside the padded grid."""

    def __init__(self, mesh: Mesh, blocks: dict, shape, hw):
        self.mesh = mesh
        self.blocks = blocks
        self.shape = tuple(shape)
        self.hw = tuple(hw)

    def slices(self, block):
        """Where ``block`` lies in the ``(B, H, W)`` result, as slices, and
        its rows and columns inside the image."""
        bl, hl, wl = self.blocks[block].shape
        d, y, x = block
        H, W = self.hw
        rows = max(0, min(hl, H - y * hl))
        cols = max(0, min(wl, W - x * wl))
        return (slice(d * bl, (d + 1) * bl), slice(y * hl, y * hl + rows),
                slice(x * wl, x * wl + cols))

    def local_shards(self):
        """``(slices, tensor)`` of each block held here, cut to the image."""
        for b, t in self.blocks.items():
            s = self.slices(b)
            yield s, t[:, :s[1].stop - s[1].start, :s[2].stop - s[2].start]

    def assemble(self) -> torch.Tensor:
        """The whole ``(B, H, W)`` result on the mesh's first device; every
        block must live in this process."""
        if len(self.blocks) != self.mesh.size:
            raise ValueError("the blocks are spread over several processes; "
                             "read local_shards() instead")
        dev = self.mesh.devices.flat[0]
        B = self.shape[0]
        first = next(iter(self.blocks.values()))
        out = torch.empty((B,) + self.hw, dtype=first.dtype, device=dev)
        for s, t in self.local_shards():
            out[s] = t.to(dev)
        return out


# ---------------------------------------------------------------------------
# generic engine: masked stages at global offsets, unpacked dilation
# ---------------------------------------------------------------------------

def _blur_shard(imgs: dict, mesh: Mesh, kernel, H: int, W: int) -> dict:
    """Renormalized separable blur of every block, int16."""
    kernel = np.asarray(kernel, np.float32)
    c = kernel.shape[0] // 2
    x = {b: t.to(torch.float32) for b, t in imgs.items()}
    xp = halo_exchange_cols(x, c, mesh)
    temp = {}
    for b, t in x.items():
        wl = t.shape[-1]
        acc = torch.zeros_like(t)
        for k in range(kernel.shape[0]):
            acc = acc + xp[b][..., k:k + wl] * float(kernel[k])
        cnt = count_vector(b[2] * wl, wl, W, kernel)
        temp[b] = acc / torch.from_numpy(cnt).to(t.device)
    tp = halo_exchange_rows(temp, c, mesh)
    out = {}
    for b, t in temp.items():
        hl = t.shape[-2]
        acc = torch.zeros_like(t)
        for k in range(kernel.shape[0]):
            acc = acc + tp[b][..., k:k + hl, :] * float(kernel[k])
        cnt = count_vector(b[1] * hl, hl, H, kernel)
        out[b] = (acc / torch.from_numpy(cnt).to(t.device)[:, None]).to(
            torch.int16)
    return out


def _grid(b, t, H, W):
    """Global row (hl, 1) and column (1, wl) indices of a block."""
    hl, wl = t.shape[-2:]
    dev = t.device
    grow = b[1] * hl + torch.arange(hl, device=dev)[:, None]
    gcol = b[2] * wl + torch.arange(wl, device=dev)[None, :]
    return grow, gcol


def _sobel_shard(sm: dict, mesh: Mesh, H: int, W: int):
    """Sobel with the reference border rules: (magnitude, angle bin)."""
    x = {b: t.to(torch.int32) for b, t in sm.items()}
    xp = halo_exchange_2d(x, 1, mesh)
    mag, ang = {}, {}
    for b, t in x.items():
        grow, gcol = _grid(b, t, H, W)
        p = xp[b]
        mid = p[..., :, 1:-1]
        d = (torch.where(gcol + 1 < W, p[..., :, 2:], mid)
             - torch.where(gcol - 1 >= 0, p[..., :, :-2], mid))
        gx = (2 * d[..., 1:-1, :] + torch.where(grow + 1 < H, d[..., 2:, :], 0)
              + torch.where(grow - 1 >= 0, d[..., :-2, :], 0))
        mid = p[..., 1:-1, :]
        e = (torch.where(grow + 1 < H, p[..., 2:, :], mid)
             - torch.where(grow - 1 >= 0, p[..., :-2, :], mid))
        gy = (2 * e[..., :, 1:-1] + torch.where(gcol + 1 < W, e[..., :, 2:], 0)
              + torch.where(gcol - 1 >= 0, e[..., :, :-2], 0))
        mag[b] = isqrt(gx * gx + gy * gy)
        ang[b] = quantize_angle(gx, gy)
    return mag, ang


def _nms_shard(mag: dict, ang: dict, mesh: Mesh, H: int, W: int) -> dict:
    mp = halo_exchange_2d(mag, 1, mesh)
    out = {}
    for b, m in mag.items():
        hl, wl = m.shape[-2:]
        grow, gcol = _grid(b, m, H, W)

        def nb(dr, dc):
            v = mp[b][..., 1 + dr:1 + dr + hl, 1 + dc:1 + dc + wl]
            inb = ((grow + dr >= 0) & (grow + dr < H)
                   & (gcol + dc >= 0) & (gcol + dc < W))
            return torch.where(inb, v, NMS_OOB)

        keep0 = (m > nb(0, -1)) & (m > nb(0, 1))
        keep45 = (m > nb(-1, 1)) & (m > nb(1, -1))
        keep90 = (m > nb(-1, 0)) & (m > nb(1, 0))
        keep135 = (m > nb(-1, -1)) & (m > nb(1, 1))
        a = ang[b]
        keep = torch.where(a == 0, keep0, torch.where(
            a == 45, keep45, torch.where(a == 90, keep90, keep135)))
        out[b] = torch.where(keep, m, NOEDGE)
    return out


def _hysteresis_shard(nm: dict, mesh: Mesh, min_val, max_val, H, W,
                      steps_per_round: int = 8, strict: bool = False) -> dict:
    """Distributed fixed point: a halo of ``k`` pixels and ``k`` dilations a
    round, until a round changes no pixel anywhere.  Padding past the image
    is never weak.  ``strict``: each dilation re-derives global pixel
    (0, 1) from its allowed sources, on the top-left block (extended
    coordinates (k, k + 1))."""
    k = steps_per_round
    weak, strong = {}, {}
    for b, t in nm.items():
        grow, gcol = _grid(b, t, H, W)
        inside = (grow < H) & (gcol < W)
        weak[b] = ((t >= min_val) & inside).to(torch.uint8)
        strong[b] = ((t >= max_val) & inside).to(torch.uint8)
        if strict and (t.shape[-2] < 2 or t.shape[-1] < 3):
            raise ValueError("strict sharded hysteresis needs blocks >= 2x3")
    wk = halo_exchange_2d(weak, k, mesh)

    def round_fn(edges):
        ext = halo_exchange_2d(edges, k, mesh)
        out = {}
        for b, e in ext.items():
            w = wk[b]
            for _ in range(k):
                g = e | shift_cols(e, 1) | shift_cols(e, -1)
                g = g | shift_rows(g, 1) | shift_rows(g, -1)
                new = w & g
                if strict and b[1] == 0 and b[2] == 0:
                    allowed = (e[..., k, k] | e[..., k + 1, k + 1]
                               | e[..., k, k + 2] | e[..., k + 1, k + 2])
                    new[..., k, k + 1] = e[..., k, k + 1] | (w[..., k, k + 1]
                                                             & allowed)
                e = new
            out[b] = e[..., k:-k, k:-k]
        return out

    edges = strong
    while True:
        new = round_fn(edges)
        changed = mesh.transport.total(_changed(new, edges))
        edges = new
        if not changed:
            break
    return {b: e.to(torch.int16) * EDGE for b, e in edges.items()}


def _changed(new: dict, old: dict) -> int:
    """The number of elements that differ, summed over the blocks here (one
    host read a device)."""
    by_dev = {}
    for b, t in new.items():
        o = old[b]
        if t.dtype == torch.uint32:
            t, o = t.view(torch.int32), o.view(torch.int32)
        by_dev.setdefault(t.device, []).append((t != o).sum())
    return sum(int(torch.stack(v).sum()) for v in by_dev.values())


def _canny_shard(imgs: dict, mesh: Mesh, min_val, max_val, *, kernel, H, W,
                 hysteresis_steps, strict=False) -> dict:
    smoothed = _blur_shard(imgs, mesh, kernel, H, W)
    mag, ang = _sobel_shard(smoothed, mesh, H, W)
    nm = _nms_shard(mag, ang, mesh, H, W)
    return _hysteresis_shard(nm, mesh, min_val, max_val, H, W,
                             hysteresis_steps, strict=strict)


# ---------------------------------------------------------------------------
# static border-class engine: K1 block mode, the distributed packed flood
# ---------------------------------------------------------------------------

def _axis_classes(n: int, block: int) -> list[int]:
    """Base offsets of the border classes along one mesh axis.

    n == 1: the one block touches both borders (base 0).  n == 2: first
    (base 0) and last (base block).  n >= 3: also one interior class,
    represented by base == block; ``ShardedCanny._static_geometry`` makes
    every interior block's dependency cone lie inside the image, so the
    front end of any interior block equals that of the representative.
    """
    if n == 1:
        return [0]
    if n == 2:
        return [0, block]
    return [0, block, (n - 1) * block]


def _class_index(i: int, n: int) -> int:
    """The border class of block ``i`` of ``n`` along one axis."""
    if i == 0 or n == 1:
        return 0
    if n == 2:
        return 1
    return 2 if i == n - 1 else 1


def _frontend_static(frames: dict, mesh: Mesh, min_val, max_val, *, taps,
                     H, W, hl, wl) -> dict:
    """{block: uint8 (hl, wl)} -> {block: packed (weak, strong) (hl, wl/32)}.

    One 2-phase halo of ``r = window // 2 + 2`` texels, then K1 in block
    mode at the offsets of the block's border class; the kernel clears the
    rows and columns past the image in both masks (``min_val == 0`` would
    otherwise mark the padding weak and bridge components across it)."""
    ny, nx = mesh.shape[Y_AXIS], mesh.shape[X_AXIS]
    r = next(iter(taps.values())).shape[0] // 2 + 2
    windows = halo_exchange_2d(frames, r, mesh)
    y_bases, x_bases = _axis_classes(ny, hl), _axis_classes(nx, wl)
    out = {}
    for b, win in windows.items():
        row0 = y_bases[_class_index(b[1], ny)]
        col0 = x_bases[_class_index(b[2], nx)]
        out[b] = frontend_block(win, row0, col0, H, W,
                                taps[win.device], (min_val, max_val))
    return out


def _flood_distributed(masks: dict, mesh: Mesh, hl: int, wl: int,
                       engine: str, strict: bool = False):
    """Distributed packed hysteresis on ``{block: (weak, strong)}``
    ``(hl, wl/32)`` masks -> ``({block: int16 {0, 255} (hl, wl)}, rounds)``.

    Each round exchanges one word column and one row of edges (the weak
    halo once, before the first), floods every extended block to its local
    fixed point (K2 for ``engine == "vmem"``, the plain packed flood for
    ``"xla"``), and sums the changed words over the mesh; the loop ends with
    the first round that changes none.  The halo is a snapshot of the
    neighbours' true state, so each added bit has a real weak path to a
    seed, and an unchanged round is the global fixed point.  ``strict``:
    the fix of global pixel (0, 1), at row 1, word 1 of the top-left block.
    """
    ny, nx = mesh.shape[Y_AXIS], mesh.shape[X_AXIS]

    def flood(weak, strong, h, w, s, quirk, int16):
        if engine == "vmem":
            return hysteresis_packed(weak, strong, h, w, strict=s,
                                     quirk_rw=quirk, edges_int16=int16)
        edges, _ = hysteresis_packed_masks(weak, strong, h, w,
                                           inner_dilate=INNER_DILATE_XLA,
                                           strict=s, quirk_rw=quirk)
        return unpack_edges(edges, w) if int16 else edges

    if ny == 1 and nx == 1:
        # each block holds whole frames: one local fixed point, no rounds
        return {b: flood(wk, st, hl, wl, strict, (0, 0), True)
                for b, (wk, st) in masks.items()}, 0
    ext_h, ext_w = hl + 2, (wl // 32 + 2) * 32
    # packed words travel as int32 (PyTorch copies, pads and concatenates
    # those on every device)
    weak = {b: m[0].view(torch.int32) for b, m in masks.items()}
    edges = {b: m[1].view(torch.int32) for b, m in masks.items()}
    wk_ext = halo_exchange_2d(weak, 1, mesh)
    rounds = 0
    while True:
        rounds += 1
        e_ext = halo_exchange_2d(edges, 1, mesh)
        new = {}
        for b, e in e_ext.items():
            s = strict and b[1] == 0 and b[2] == 0
            out = flood(wk_ext[b].view(torch.uint32), e.view(torch.uint32),
                        ext_h, ext_w, s, (1, 1), False)
            new[b] = out.view(torch.int32)[1:-1, 1:-1]
        changed = mesh.transport.total(_changed(new, edges))
        edges = new
        if not changed:
            break
    return {b: unpack_edges(e.contiguous().view(torch.uint32), wl)
            for b, e in edges.items()}, rounds


def _canny_static(imgs: dict, mesh: Mesh, min_val, max_val, *, taps, H, W,
                  hl, wl, flood, strict=False, rounds=None) -> dict:
    """The static engine on ``{block: (bl, hl, wl)}``, a frame at a time
    over all blocks (every block holds the same number of frames); the
    flood's rounds of each frame are appended to ``rounds``."""
    bl = next(iter(imgs.values())).shape[0]
    outs = {b: [] for b in imgs}
    for f in range(bl):
        masks = _frontend_static({b: t[f] for b, t in imgs.items()}, mesh,
                                 min_val, max_val, taps=taps, H=H, W=W,
                                 hl=hl, wl=wl)
        edges, n = _flood_distributed(masks, mesh, hl, wl, flood,
                                      strict=strict)
        if rounds is not None:
            rounds.append(n)
        for b, e in edges.items():
            outs[b].append(e)
    return {b: torch.stack(v) for b, v in outs.items()}


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------

class ShardedCanny:
    """Batch-of-frames Canny over a ("data", "y", "x") mesh of blocks.

    Input: uint8 ``(B, H, W)`` with ``B % data == 0`` (an array, a tensor or
    the :class:`ShardedBatch` of :meth:`shard_batch`).  Any ``H, W``: the
    batch is zero-padded to the block grid and the padding cut from the
    result.  Output: int16 {0, 255} ``(B, H, W)`` on the mesh's first
    device; on a mesh spread over several processes, the
    :class:`ShardedBatch` of this process's blocks of it.  After a call of
    the static engine, ``rounds`` lists the distributed flood's rounds of
    each frame (0 on a 1x1 spatial mesh, which needs none).

    Example::

        mesh = make_mesh([torch.device("cuda")] * 8, y=2, x=4)
        model = ShardedCanny(mesh, sigma=1.4, image_shape=(2160, 3840))
        edges = model(batch_u8, 50, 150)
    """

    def __init__(self, mesh: Mesh, sigma: float, image_shape,
                 hysteresis_steps: int = 8, frontend: str = "auto",
                 flood: str = "auto", hysteresis_mode: str = "component"):
        self.sigma = sigma
        self._setup(mesh, gaussian_kernel(sigma), image_shape,
                    hysteresis_steps, frontend, flood, hysteresis_mode)

    @classmethod
    def from_numpy_params(cls, mesh: Mesh, kernel: np.ndarray, image_shape,
                          hysteresis_steps: int = 8, frontend: str = "auto",
                          flood: str = "auto",
                          hysteresis_mode: str = "component"):
        """A model with the given float32 Gaussian taps (e.g. the JAX
        package's ``ShardedCanny.kernel``)."""
        model = cls.__new__(cls)
        model.sigma = None
        model._setup(mesh, kernel, image_shape, hysteresis_steps, frontend,
                     flood, hysteresis_mode)
        return model

    def _setup(self, mesh, kernel, image_shape, hysteresis_steps, frontend,
               flood, hysteresis_mode):
        if hysteresis_mode not in ("component", "strict-reference"):
            raise ValueError(f"unknown hysteresis mode: {hysteresis_mode!r}")
        if frontend not in ("auto", "static", "generic"):
            raise ValueError(f"unknown frontend: {frontend}")
        if flood not in ("auto", "vmem", "xla", "generic"):
            raise ValueError(f"unknown flood engine: {flood}")
        kernel = np.asarray(kernel, np.float32)
        if kernel.ndim != 1 or kernel.shape[0] % 2 != 1:
            raise ValueError("kernel must be 1-D with an odd number of taps")
        self.hysteresis_mode = hysteresis_mode
        self.strict = hysteresis_mode == "strict-reference"
        self.hysteresis_steps = hysteresis_steps
        self.mesh = mesh
        self.kernel = kernel
        self.H, self.W = (int(v) for v in image_shape)
        ny, nx = mesh.shape[Y_AXIS], mesh.shape[X_AXIS]
        c = kernel.shape[0] // 2
        r = c + 2

        hl = wl = None
        if frontend in ("auto", "static"):
            hl, wl = self._static_geometry(ny, nx, r)
            if hl is None and frontend == "static":
                raise ValueError(
                    f"static engine needs every interior block's dependency "
                    f"cone inside the image; {self.H}x{self.W} over "
                    f"{ny}x{nx} blocks violates it — use frontend='auto'")
        self.engine = "static" if hl is not None else "generic"
        if self.engine == "static":
            if flood == "auto":
                on_card = mesh.devices.flat[0].type == "cuda"
                flood = "vmem" if on_card else "xla"
            elif flood == "generic":
                flood = "xla"
            self.flood = flood
        else:
            # per-block dims ceil-divided, grown to the widest halo any
            # stage exchanges
            halo = max(c, hysteresis_steps, 1)
            hl = max(cdiv(self.H, ny), halo)
            wl = max(cdiv(self.W, nx), halo)
            self.flood = "generic"
        self.hl, self.wl = hl, wl
        self.Hp, self.Wp = hl * ny, wl * nx
        self._taps = {}
        for dev in set(mesh.devices.flat):
            self._taps[dev] = torch.from_numpy(kernel.copy()).to(dev)

    def _static_geometry(self, ny: int, nx: int, r: int):
        """Block dims (hl, wl) for the static engine, or (None, None).

        Blocks at least r tall and wide (a halo comes whole from one
        neighbour), widths a multiple of 32 (a packed word never straddles
        two blocks), and, where interior classes exist, every interior
        block's dependency cone inside the image.  8-row-aligned blocks
        first, then exact ceil-division: JAX's rule, so that ``engine``
        agrees with JAX's at every shape.
        """
        def up(a, m):
            return -(-a // m) * m

        for align_h in (8, 1):
            hl = up(max(cdiv(self.H, ny), r), align_h)
            wl = up(max(cdiv(self.W, nx), r), 32)
            ok = ((ny < 3 or (ny - 1) * hl + r <= self.H)
                  and (nx < 3 or (nx - 1) * wl + r <= self.W))
            if ok:
                return hl, wl
        return None, None

    def shard_batch(self, imgs) -> ShardedBatch:
        """Pad a host batch ``(B, H, W)`` to the block grid and place this
        process's blocks on their devices."""
        if isinstance(imgs, ShardedBatch):
            return imgs
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))
        if imgs.dim() != 3:
            raise ValueError("expected (B, H, W)")
        if imgs.dtype != torch.uint8:
            raise TypeError("input image must be uint8 grayscale")
        B, h, w = imgs.shape
        if (h, w) not in ((self.H, self.W), (self.Hp, self.Wp)):
            raise ValueError(f"expected frames of {self.H}x{self.W}, got "
                             f"{h}x{w}")
        nd = self.mesh.shape[DATA_AXIS]
        if B % nd:
            raise ValueError(f"batch {B} is not a multiple of the mesh's "
                             f"data axis ({nd})")
        if (h, w) != (self.Hp, self.Wp):
            imgs = F.pad(imgs, (0, self.Wp - w, 0, self.Hp - h))
        bl, hl, wl = B // nd, self.hl, self.wl
        blocks = {}
        for b in self.mesh.local_blocks:
            d, y, x = b
            blocks[b] = imgs[d * bl:(d + 1) * bl, y * hl:(y + 1) * hl,
                             x * wl:(x + 1) * wl].to(
                self.mesh.device_of(b)).contiguous()
        return ShardedBatch(self.mesh, blocks, (B, self.Hp, self.Wp),
                            (self.H, self.W))

    def __call__(self, imgs, min_val: int, max_val: int):
        if not isinstance(imgs, ShardedBatch) and imgs.ndim != 3:
            raise ValueError("expected (B, H, W)")
        batch = self.shard_batch(imgs)
        self.rounds = []
        if self.engine == "static":
            out = _canny_static(
                batch.blocks, self.mesh, min_val, max_val, taps=self._taps,
                H=self.H, W=self.W, hl=self.hl, wl=self.wl, flood=self.flood,
                strict=self.strict and self.H >= 2 and self.W >= 2,
                rounds=self.rounds)
        else:
            out = _canny_shard(
                batch.blocks, self.mesh, min_val, max_val, kernel=self.kernel,
                H=self.H, W=self.W, hysteresis_steps=self.hysteresis_steps,
                strict=self.strict)
        res = ShardedBatch(self.mesh, out, batch.shape, batch.hw)
        return res.assemble() if len(out) == self.mesh.size else res

