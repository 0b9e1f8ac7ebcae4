"""The system under test, and the only module of the benchmark that imports
it: ``canny_edge_tpu_torch``'s model class.

The benchmark takes from the program nothing but these entry points; the
frames, the reference and the floors are the benchmark's own.
"""

from __future__ import annotations


def make_model(config: dict, device):
    """``CannyTorch`` as the configuration states it."""
    from canny_edge_tpu_torch import CannyTorch

    return CannyTorch(sigma=config["sigma"],
                      hysteresis_mode=config["hysteresis_mode"],
                      device=device, backend=config["backend"])


def make_control_model(config: dict, device):
    """The control: the program's own path for given taps
    (``CannyTorch.from_numpy_params``) with the configuration's float32
    taps, worked out by the oracle, rounded to bfloat16."""
    import torch

    from canny_edge_tpu_torch import CannyTorch
    from portbench.reference.oracle import gaussian_kernel

    taps = torch.from_numpy(gaussian_kernel(config["sigma"]))
    taps = taps.to(torch.bfloat16).to(torch.float32).numpy()
    return CannyTorch.from_numpy_params(
        taps, hysteresis_mode=config["hysteresis_mode"], device=device,
        backend=config["backend"])

