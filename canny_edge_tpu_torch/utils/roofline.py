"""The card's floors: per stage of a backend and per kernel
(``canny_edge_tpu/utils/roofline.py``).

Each stage, and each kernel, has two floors:

* memory floor: each input byte read once and each output byte written once
  (perfect fusion), at the card's published HBM rate;
* compute floor: the operations the stage must do, at the card's rate for
  separate operations.  Exactness forbids fusing a multiply and an add (the
  blur rounds every product and every sum on its own) and the rest of the
  work is integer and bit operations, one a lane a cycle, so that rate is
  half the published float32 rate, which counts an FMA as two.

The least time is the larger of the two; ``bound`` names it.  The compute
floor counts the work of the function, not of a kernel: with an audit
(:mod:`.opcount` on the plain version) it is the audited ``alu`` operations
a pixel (``floor_model: "audit_alu"``), without one the hand model below
(``"hand_modeled_alu"``).  Each row carries both counts, so the gap between
them is on record.

The peak table is keyed by ``torch.cuda.get_device_name()``, the
``device_kind`` argument (JAX's name); a card not in it gets no floors
(``None``) and ``"bound": "unknown card"``: there is no default peak.  The
JAX package's two-bucket floor charged movement at a rate measured on its
chip; no such rate was measured on this card, so it is not offered.
"""

from __future__ import annotations

from dataclasses import dataclass

H100_SXM = "NVIDIA H100 80GB HBM3"

# NVIDIA's data sheet, H100 SXM, at its 700 W limit: the HBM3 rate (bytes a
# second) and the float32 rate outside the tensor cores (an FMA counts two)
PEAKS = {
    H100_SXM: {"hbm_bytes_per_s": 3.35e12, "f32_fma_ops_per_s": 67e12},
}
HBM_BYTES_PER_S = PEAKS[H100_SXM]["hbm_bytes_per_s"]
F32_FMA_OPS_PER_S = PEAKS[H100_SXM]["f32_fma_ops_per_s"]
SEPARATE_OPS_PER_S = F32_FMA_OPS_PER_S / 2

# The hand model of the work.  K1: 2 passes x (window products + window
# sums) + 2 divides + floor, ~14 Sobel, ~10 magnitude, ~16 NMS and 2
# threshold operations a pixel.  K2: one dilation and a row and a column
# flood over every packed word, ~40 operations a word.  From an NMS map to
# int16 edges: two compares and a select a pixel more.
K2_OPS_PER_WORD = 40
NM_INT16_OPS_PER_PX = 3


def k1_ops_per_px(window: int) -> int:
    """The hand model's operations a pixel of the front end."""
    return 4 * window + 45


def chip_peaks(device_kind: str) -> dict | None:
    """The card's published peaks, or None for a card not in the table."""
    return PEAKS.get(device_kind)


def chip_bandwidth_gbps(device_kind: str) -> float | None:
    """Published HBM rate in GB/s, or None for an unknown card."""
    peaks = chip_peaks(device_kind)
    return None if peaks is None else peaks["hbm_bytes_per_s"] / 1e9


def chip_ops_per_s(device_kind: str) -> float | None:
    """Separate (unfused) operations a second, half the published float32
    rate; None for an unknown card.  The counterpart of ``chip_vpu_ops``."""
    peaks = chip_peaks(device_kind)
    return None if peaks is None else peaks["f32_fma_ops_per_s"] / 2


@dataclass
class StageTraffic:
    """Least bytes moved and operations done a pixel by one stage."""
    name: str
    bytes_per_pixel: float
    ops_per_pixel: float = 0.0

    def mem_seconds(self, pixels: int, bw_gbps: float) -> float:
        return self.bytes_per_pixel * pixels / (bw_gbps * 1e9)

    def compute_seconds(self, pixels: int, vpu_ops: float) -> float:
        """``vpu_ops``: the card's rate of separate operations a second
        (JAX's name, for its vector unit's rate)."""
        return self.ops_per_pixel * pixels / vpu_ops


def backend_stages(backend: str, window: int = 11) -> list[StageTraffic]:
    """The two stages of a backend, counted from what its kernels (or, for
    ``xla``, its plain ops) read and write, at a Gaussian ``window``:

    * ``fused``: K1 with the thresholds (u8 in, two packed masks out:
      1.25 B/px), then K2 (the masks in, int16 out: 2.25 B/px);
    * ``pallas``: K1 to the int16 NMS map (3 B/px), then K2 from the map
      (int16 in and out: 4 B/px);
    * ``xla``: the plain front end writes an int32 NMS map (5 B/px), the
      plain flood reads it and writes int16 (6 B/px).
    """
    fe_ops = k1_ops_per_px(window)
    k2_ops = K2_OPS_PER_WORD / 32
    masks = 2 * 4 / 32
    if backend == "fused":
        return [StageTraffic("frontend", 1 + masks, fe_ops),
                StageTraffic("hysteresis", masks + 2, k2_ops)]
    nm_bytes = {"pallas": 2, "xla": 4}[backend]
    return [StageTraffic("frontend", 1 + nm_bytes, fe_ops),
            StageTraffic("hysteresis", nm_bytes + 2,
                         k2_ops + NM_INT16_OPS_PER_PX)]


def stage_rooflines(pixels: int, measured_seconds: dict[str, float],
                    device_kind: str, backend: str = "xla",
                    audited_ops: dict[str, dict] | None = None,
                    window: int = 11) -> list[dict]:
    """One row a measured stage: its time, both floors, the binding one
    (``sol_ms``, ``bound``) and ``pct_of_sol`` = 100 x floor / time.

    ``audited_ops``: optional ``{stage: opcount audit}``; a stage with an
    audited ``alu`` count takes it as its compute floor (``floor_model``
    ``"audit_alu"``), else the hand model's (``"hand_modeled_alu"``).
    Every row holds ``est_ops_per_px`` (the hand model) and ``audit`` (the
    audit's buckets, or None).  An unknown ``device_kind`` gives None floors
    and ``"bound": "unknown card"``.
    """
    bw = chip_bandwidth_gbps(device_kind)
    ops_rate = chip_ops_per_s(device_kind)
    by_name = {s.name: s for s in backend_stages(backend, window)}
    rows = []
    for name, sec in measured_seconds.items():
        s = by_name.get(name)
        if s is None or sec <= 0:
            continue
        buckets = ((audited_ops or {}).get(name) or {}).get("buckets") or None
        alu = (buckets or {}).get("alu")
        row = {
            "stage": name,
            "ms": round(sec * 1e3, 6),
            "min_hbm_bytes_per_px": s.bytes_per_pixel,
            "est_ops_per_px": s.ops_per_pixel,
            "audit": buckets,
            "floor_model": "audit_alu" if alu else "hand_modeled_alu",
        }
        if bw is None:
            row.update(mem_sol_ms=None, compute_sol_ms=None, sol_ms=None,
                       bound="unknown card", pct_of_sol=None)
        else:
            mem = s.mem_seconds(pixels, bw)
            comp = (alu or s.ops_per_pixel) * pixels / ops_rate
            floor = max(mem, comp)
            row.update(mem_sol_ms=round(mem * 1e3, 6),
                       compute_sol_ms=round(comp * 1e3, 6),
                       sol_ms=round(floor * 1e3, 6),
                       bound="alu" if comp >= mem else "hbm",
                       pct_of_sol=round(100.0 * floor / sec, 1))
        rows.append(row)
    return rows


def report(pixels: int, measured_seconds: dict[str, float],
           device_kind: str, stages=None, backend: str = "xla",
           window: int = 11) -> str:
    """Text roofline: stage, time, least time, what binds, % of it (from
    the hand model, or ``stages``)."""
    by_name = {s.name: s for s in (stages if stages is not None
                                   else backend_stages(backend, window))}
    bw = chip_bandwidth_gbps(device_kind)
    if bw is None:
        return f"roofline vs {device_kind}: unknown card, no floors"
    ops_rate = chip_ops_per_s(device_kind)
    lines = [f"roofline vs {device_kind} @ {bw:.0f} GB/s HBM, "
             f"{ops_rate / 1e12:.2f} Tops separate",
             f"{'stage':<18}{'ms':>9}{'min ms':>9}{'bound':>7}"
             f"{'% of SoL':>10}"]
    for name, sec in measured_seconds.items():
        s = by_name.get(name)
        if s is None:
            continue
        mem = s.mem_seconds(pixels, bw)
        comp = s.compute_seconds(pixels, ops_rate)
        floor = max(mem, comp)
        pct = 100.0 * floor / sec if sec > 0 else 0.0
        bound = "alu" if comp >= mem else "hbm"
        lines.append(f"{name:<18}{sec * 1e3:>9.3f}{floor * 1e3:>9.3f}"
                     f"{bound:>7}{pct:>9.1f}%")
    return "\n".join(lines)


def _bound(nbytes: int, ops: int) -> dict:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / SEPARATE_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def kernel_bounds(hw=(1080, 1920), window: int = 11, block=(1080, 960),
                  extended=(1082, 1024), batch=None,
                  wide=(64, 131072), tile=(10980, 10980)) -> dict[str, dict]:
    """``{kernel: {"bound_ms", "bound_by"}}``: each kernel's least time on
    the H100 SXM at the shapes ``chip_smoke.py`` runs it, from the hand
    model (each input byte read once, each output byte written once).
    ``batch``: the bounds of one launch on ``batch`` frames of each shape,
    ``batch`` times the frame's bytes and operations.

    ``hw``: the frame of K1 (with the thresholds), K2 (masks in, packed
    out), K2 from an NMS map to int16 (``hysteresis_packed_nm_int16``), K3
    and K4 (int16 map in and out).  ``block``: a ``(hl, wl)`` block of K1's
    block mode, read with a halo of ``window // 2 + 2``.  ``extended``: the
    ``(rows, columns)`` of the halo-extended masks K2 floods with the strict
    fix at ``quirk_rw=(1, 1)``.  K1's ring and scratch paths compute
    ``frontend`` at their windows: their bound is ``frontend``'s at that
    ``window``.  ``wide``: the ``(rows, columns)`` of K4's wide path
    (``hysteresis_banded_wide``), bounded as the same function at that
    width.  ``tile``: the uint16 frame of K1's uint16 instantiation
    (``frontend_u16``: 2 bytes a pixel in, the packed masks out).
    """
    h, w = hw
    wd = -(-w // 32)
    k2_ops = K2_OPS_PER_WORD * h * wd

    def engine(rows, cols):     # K3 / K4: int16 map in, int16 edges out
        return (4 * rows * cols, NM_INT16_OPS_PER_PX * rows * cols
                + K2_OPS_PER_WORD * rows * -(-cols // 32))

    hl, wl = block
    r = window // 2 + 2
    eh, ewd = extended[0], extended[1] // 32
    n = 1 if batch is None else batch
    return {k: _bound(n * b, n * o) for k, (b, o) in {
        "frontend": (h * w + 2 * h * wd * 4, h * w * k1_ops_per_px(window)),
        "hysteresis_packed": (3 * h * wd * 4, k2_ops),
        "hysteresis_packed_nm_int16": (4 * h * w,
                                       k2_ops + NM_INT16_OPS_PER_PX * h * w),
        "hysteresis_dilate": engine(h, w),
        "hysteresis_banded": engine(h, w),
        "frontend_block": (
            (hl + 2 * r) * (wl + 2 * r) + 2 * hl * (wl // 32) * 4,
            hl * wl * k1_ops_per_px(window)),
        "hysteresis_packed_quirk": (3 * eh * ewd * 4,
                                    K2_OPS_PER_WORD * eh * ewd),
        "hysteresis_banded_wide": engine(*wide),
        "frontend_u16": (2 * tile[0] * tile[1]
                         + 2 * tile[0] * -(-tile[1] // 32) * 4,
                         tile[0] * tile[1] * k1_ops_per_px(window)),
    }.items()}
