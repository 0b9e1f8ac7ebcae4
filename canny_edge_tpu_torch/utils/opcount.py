"""Operations a pixel of a plain PyTorch function: the roofline's count of
the work (``canny_edge_tpu/utils/opcount.py``).

The JAX package counts the instructions of the compiled XLA program.  Here
the count is of the plain PyTorch version that stands beside each kernel
(``ops/window.py``, ``ops/packed.py``): the function is run once under a
``TorchDispatchMode``, which sees every aten operation it issues, and each
operation's output elements, divided by the pixels, go to a bucket
(``canny_edge_tpu/utils/opcount.py:28-41``):

* ``alu``      elementwise arithmetic, logic, compares and selects: the
               compute floor's currency;
* ``convert``  dtype conversions;
* ``movement`` copies, pads, concatenations, gathers, fills and ranges:
               materialised data movement, reported beside the floor and
               not added to it;
* ``reduce``   reductions (the 32-to-1 packing's sums, convergence tests).

Views (``slice``, ``view``, ``expand``, ``permute``, ``select``,
``unsqueeze``, ``detach``, ``alias``, ...) move no data in PyTorch and are
skipped, as JAX skips its bookkeeping instructions; in HLO they would
materialise, here they are free.  What is counted is the plain
formulation's work, whatever device it runs on, never a kernel's: a kernel
is one opaque call.  ``audit_hlo_text`` has no counterpart: there is no HLO.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# aten names after :func:`op_name`'s normalisation
ALU = {
    "add", "sub", "rsub", "mul", "div", "floor_divide", "remainder", "fmod",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "masked_fill", "eq", "ne", "lt", "le", "gt", "ge", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_xor", "logical_not", "and", "or", "xor", "lshift", "rshift",
    "bitwise_left_shift", "bitwise_right_shift", "abs", "neg", "sign",
    "floor", "ceil", "round", "trunc", "sqrt", "rsqrt", "reciprocal", "pow",
    "exp", "log",
}
CONVERT = {"to_copy"}             # a conversion where the dtype changes
MOVEMENT = {"copy", "clone", "cat", "stack", "constant_pad_nd", "pad",
            "index", "index_select", "gather", "scatter", "index_put", "flip",
            "roll", "repeat", "fill", "zeros", "zeros_like", "ones",
            "ones_like", "full", "full_like", "arange", "scalar_tensor"}
REDUCE = {"sum", "prod", "amax", "amin", "max", "min", "any", "all",
          "argmax", "argmin", "mean", "cumsum", "count_nonzero"}
# no data written: views, allocation, reading a scalar back
SKIP = {"slice", "view", "unsafe_view", "expand", "permute", "select",
        "unsqueeze", "squeeze", "detach", "alias", "t", "transpose",
        "as_strided", "lift_fresh", "empty", "empty_like", "empty_strided",
        "local_scalar_dense", "equal"}


def op_name(func) -> str:
    """The aten name of ``func`` with the underscores of in-place and
    operator forms stripped: ``add_`` -> ``add``, ``__lshift__`` ->
    ``lshift``, ``_to_copy`` -> ``to_copy``."""
    return func.overloadpacket.__name__.strip("_")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


class OpAudit(TorchDispatchMode):
    """A dispatch mode that counts, while it is entered, the output
    elements and bytes of every operation by bucket and by name."""

    def __init__(self):
        super().__init__()
        self.elems = defaultdict(int)       # bucket -> output elements
        self.by_op = defaultdict(int)       # name -> output elements
        self.bytes = 0                      # bytes of non-view outputs
        self.ops = 0                        # operations counted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = op_name(func)
        if name in SKIP or func.is_view:
            return out
        outs = list(_tensors(out))
        n = sum(t.numel() for t in outs)
        if name in ALU or (name in ("max", "min")
                           and func._overloadname == "other"):
            bucket = "alu"
        elif name in CONVERT:
            src = next(_tensors(args), None)
            bucket = ("convert" if src is None or src.dtype != outs[0].dtype
                      else "movement")      # a copy to another device
        elif name in MOVEMENT:
            bucket = "movement"
        elif name in REDUCE:
            bucket = "reduce"
        else:
            bucket = "other"
        self.elems[bucket] += n
        self.by_op[name] += n
        self.bytes += sum(t.numel() * t.element_size() for t in outs)
        self.ops += 1
        return out


def audit_compiled(fn, *args, pixels: int) -> dict:
    """Per-pixel operation counts of ``fn(*args)``, run once here, where
    its arguments lie.  The JAX name is kept; nothing is compiled.

    Returns ``{"buckets": {bucket: elements a pixel}, "top_ops": {name:
    elements a pixel, the 20 largest}, "materialized_bytes_per_px",
    "operations"}``.  ``fn`` must be a plain version: a kernel's launch is
    no aten operation, and the audit would see only its output's allocation.
    """
    audit = OpAudit()
    with audit:
        fn(*args)
    per = {k: round(v / pixels, 2) for k, v in sorted(audit.elems.items())}
    top = sorted(audit.by_op.items(), key=lambda kv: -kv[1])[:20]
    return {"buckets": per,
            "top_ops": {k: round(v / pixels, 2) for k, v in top},
            **materialization_bytes(audit, pixels)}


def materialization_bytes(audit: OpAudit, pixels: int) -> dict:
    """Bytes written a pixel by the counted (non-view) operations of an
    audit, and their number: the counterpart of
    ``hbm_materialization_bytes``.  Eager PyTorch writes every operation's
    output to memory, so this is the plain version's traffic, against
    which a kernel's one read and one write are the saving."""
    return {"materialized_bytes_per_px": round(audit.bytes / pixels, 2),
            "operations": audit.ops}
