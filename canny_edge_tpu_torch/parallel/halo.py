"""Halo exchange between the blocks of a ("data", "y", "x") mesh.

The counterpart of ``canny_edge_tpu/parallel/halo.py``, where each device of
a JAX mesh held one block and ``lax.ppermute`` moved the strips.  Here a
process holds some of the blocks, and the stage code runs bulk-synchronous
over them: a stage takes and returns a dict ``{block: tensor}`` keyed by the
block's ``(data, y, x)`` index, for the blocks this process holds.  The
strips move through the mesh's transport:

* :class:`LocalTransport`: every block lives in this process, on one device
  or several (the counterpart of JAX's fake CPU devices, and how a mesh of
  many blocks runs on one card); a strip is taken from its neighbour, or
  copied to the neighbour's device;
* :class:`GroupTransport`: the blocks are spread over the ranks of a
  ``torch.distributed`` process group (one a rank, or several); strips
  between ranks go by ``batch_isend_irecv`` and a count is summed by
  ``all_reduce`` (gloo on the CPU, NCCL on cards, one card a rank).

Blocks at the image border receive zeros; stage math applies the true border
rules from global coordinates, so the fill is never read as image.  The 2-D
exchange runs columns first, then rows of the column-padded blocks, so the
corner strips travel through the edge neighbours.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DATA_AXIS = "data"
Y_AXIS = "y"
X_AXIS = "x"
AXES = (DATA_AXIS, Y_AXIS, X_AXIS)


class Mesh:
    """A grid of blocks with axes ("data", "y", "x").

    ``devices``: object array of shape (data, y, x), the device of each
    block; ``ranks``: int array of the same shape, the rank of the process
    group that holds each block, or None when this process holds them all.
    ``shape`` gives the size of each axis by name, as a JAX mesh's does.
    """

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None):
        self.devices = devices
        self.ranks = ranks
        self.shape = dict(zip(AXES, devices.shape))
        if ranks is None:
            self.rank = 0
            self.transport = LocalTransport(self)
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank()
            self.transport = GroupTransport(self)
        self.local_blocks = [b for b in np.ndindex(devices.shape)
                             if self.rank_of(b) == self.rank]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def rank_of(self, block) -> int:
        return 0 if self.ranks is None else int(self.ranks[block])

    def device_of(self, block) -> torch.device:
        return self.devices[block]

    def neighbour(self, block, axis: str, step: int):
        """The block ``step`` places along ``axis``, or None past the edge."""
        a = AXES.index(axis)
        i = block[a] + step
        if not 0 <= i < self.devices.shape[a]:
            return None
        return block[:a] + (i,) + block[a + 1:]

    def __repr__(self):
        devices = sorted(set(map(str, self.devices.flat)))
        spread = "" if self.ranks is None else ", over ranks"
        return f"Mesh({self.shape}, devices={devices}{spread})"


class LocalTransport:
    """Moves strips between blocks that all live in this process."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def shift(self, strips: dict, axis: str, step: int) -> dict:
        """``{block: strip}`` -> ``{block: the strip of the block `step`
        places before it along `axis`}``, zeros where there is none."""
        out = {}
        for b, s in strips.items():
            src = self.mesh.neighbour(b, axis, -step)
            if src is None:
                out[b] = torch.zeros_like(s)
            else:
                out[b] = self._fetch(src, b, strips)
        self._finish(out)
        return out

    def _fetch(self, src, dst, strips):
        return strips[src].to(self.mesh.device_of(dst))

    def _finish(self, out: dict) -> None:
        pass

    def total(self, n: int) -> int:
        """The sum of ``n`` over every process of the mesh."""
        return int(n)


class GroupTransport(LocalTransport):
    """Moves strips between blocks spread over a ``torch.distributed``
    process group: a strip of a block on another rank goes by one
    point-to-point message, all of a shift's messages in one batch."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        import torch.distributed as dist

        self.dist = dist
        self.comm_device = (torch.device("cuda", torch.cuda.current_device())
                            if dist.get_backend() == "nccl"
                            else torch.device("cpu"))
        self._ops = []

    def _tag(self, block) -> int:
        """A message's tag: the flat index of the block that receives it."""
        return int(np.ravel_multi_index(block, self.mesh.devices.shape))

    def shift(self, strips: dict, axis: str, step: int) -> dict:
        dist, mesh = self.dist, self.mesh
        # sends first, in block order: the receiver posts its receives in
        # the same order (gloo also matches them by tag)
        for b, s in strips.items():
            dst = mesh.neighbour(b, axis, step)
            if dst is not None and mesh.rank_of(dst) != mesh.rank:
                self._ops.append(dist.P2POp(dist.isend, s.contiguous(),
                                            mesh.rank_of(dst),
                                            tag=self._tag(dst)))
        return super().shift(strips, axis, step)

    def _fetch(self, src, dst, strips):
        if self.mesh.rank_of(src) == self.mesh.rank:
            return super()._fetch(src, dst, strips)
        like = strips[dst]
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device=self.mesh.device_of(dst))
        self._ops.append(self.dist.P2POp(self.dist.irecv, buf,
                                         self.mesh.rank_of(src),
                                         tag=self._tag(dst)))
        return buf

    def _finish(self, out: dict) -> None:
        if self._ops:
            for req in self.dist.batch_isend_irecv(self._ops):
                req.wait()
            self._ops = []

    def total(self, n: int) -> int:
        t = torch.tensor([int(n)], dtype=torch.int64, device=self.comm_device)
        self.dist.all_reduce(t)
        return int(t.item())


def halo_exchange_cols(blocks: dict, r: int, mesh: Mesh,
                       axis_name: str = X_AXIS) -> dict:
    """{block: (..., H, W)} -> {block: (..., H, W + 2r)}: column halos
    from the neighbours along ``axis_name``, zeros at the image border.
    Needs every block at least ``r`` wide."""
    if r == 0:
        return blocks
    if mesh.shape[axis_name] == 1:
        return {b: F.pad(x, (r, r)) for b, x in blocks.items()}
    left = mesh.transport.shift({b: x[..., -r:] for b, x in blocks.items()},
                                axis_name, 1)
    right = mesh.transport.shift({b: x[..., :r] for b, x in blocks.items()},
                                 axis_name, -1)
    return {b: torch.cat([left[b], x, right[b]], dim=-1)
            for b, x in blocks.items()}


def halo_exchange_rows(blocks: dict, r: int, mesh: Mesh,
                       axis_name: str = Y_AXIS) -> dict:
    """{block: (..., H, W)} -> {block: (..., H + 2r, W)}: row halos."""
    if r == 0:
        return blocks
    if mesh.shape[axis_name] == 1:
        return {b: F.pad(x, (0, 0, r, r)) for b, x in blocks.items()}
    top = mesh.transport.shift({b: x[..., -r:, :] for b, x in blocks.items()},
                               axis_name, 1)
    bottom = mesh.transport.shift(
        {b: x[..., :r, :] for b, x in blocks.items()}, axis_name, -1)
    return {b: torch.cat([top[b], x, bottom[b]], dim=-2)
            for b, x in blocks.items()}


def halo_exchange_2d(blocks: dict, r: int, mesh: Mesh,
                     y_axis: str = Y_AXIS, x_axis: str = X_AXIS) -> dict:
    """Two-phase 2-D halo exchange with corners: (..., H + 2r, W + 2r)."""
    return halo_exchange_rows(halo_exchange_cols(blocks, r, mesh, x_axis), r,
                              mesh, y_axis)
