"""The benchmark's frozen floors against the program's hand model as it
stood when the benchmark was defined (``utils/roofline.py``).  From then on
the benchmark's copy is what counts: a change to the program's model does
not move the yardstick."""

import pytest

from canny_edge_tpu_torch.utils.roofline import (
    H100_SXM,
    kernel_bounds,
    stage_rooflines,
)
from portbench.harness.spec import load_metric

K1 = load_metric("k1_roofline")
K2 = load_metric("k2_roofline")


def test_k1_floor_is_kernel_bounds_frontend():
    ms = K1.frame_floor_s(1080, 1920, 11, H100_SXM) * 1e3
    assert ms == pytest.approx(kernel_bounds()["frontend"]["bound_ms"],
                               rel=1e-12)
    assert round(ms, 5) == 0.00551
    for window in (19, 121):
        assert K1.frame_floor_s(2160, 3840, window, H100_SXM) * 1e3 == \
            pytest.approx(kernel_bounds(hw=(2160, 3840), window=window)[
                "frontend"]["bound_ms"], rel=1e-12)


def test_k2_floor_is_kernel_bounds_hysteresis_packed():
    packed = K2.frame_floor_s(1080, 1920, H100_SXM, int16_out=False) * 1e3
    assert packed == pytest.approx(
        kernel_bounds()["hysteresis_packed"]["bound_ms"], rel=1e-12)
    int16 = K2.frame_floor_s(1080, 1920, H100_SXM) * 1e3
    row = stage_rooflines(1080 * 1920, {"hysteresis": 1e-3}, H100_SXM,
                          backend="fused")[0]
    assert round(int16, 6) == row["mem_sol_ms"]     # it rounds to 6 places
    assert round(int16, 5) == 0.00139


def test_unknown_card_has_no_floor():
    assert K1.frame_floor_s(1080, 1920, 11, "cpu") is None
    assert K2.frame_floor_s(1080, 1920, "cpu") is None


@pytest.mark.parametrize("name,k1,k2", [
    ("void (anonymous namespace)::frontend_kernel<11>((anonymous "
     "namespace)::Frame, float const*, int,", True, False),
    ("void (anonymous namespace)::frontend_ring_kernel(Frame)", True, False),
    ("(anonymous namespace)::frontend_tail_kernel(Frame)", True, False),
    ("(anonymous namespace)::large_xpass(Frame, float const*)", True, False),
    ("void (anonymous namespace)::flood_kernel<false>((anonymous "
     "namespace)::Args)", False, True),
    ("Memcpy DtoH (Device -> Pinned)", False, False),
    ("void at::native::vectorized_elementwise_kernel<4>", False, False),
])
def test_kernel_names(name, k1, k2):
    assert K1.is_k1(name) is k1
    assert K2.is_k2(name) is k2
