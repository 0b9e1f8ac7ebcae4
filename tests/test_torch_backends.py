"""PyTorch port, the model's backends: ``CannyTorch(backend="pallas")`` and
``backend="xla"`` against ``CannyTPU`` with the same backend (``__call__``,
``batch`` and ``packed``, both hysteresis modes) and against the ``fused``
backend and the NumPy oracle.  Tolerance: 0 differing pixels.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu.golden.reference import gaussian_kernel
from canny_edge_tpu.io.imageio import synthetic_image
from canny_edge_tpu_torch import CannyTorch

MODES = ["component", "strict-reference"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_model_backend_vs_cannytpu(backend, mode):
    from canny_edge_tpu.models import CannyTPU

    # W <= 32 keeps the JAX flood on XLA (its Pallas flood needs two words)
    # while the port still runs every stage of the backend
    frames = np.stack([synthetic_image(40, 32, seed=s) for s in range(2)])
    frames[:, 1, 0] = 255                 # beside the strict mode's quirk
    ref = CannyTPU(sigma=1.4, backend=backend, hysteresis_mode=mode)
    model = CannyTorch(1.4, hysteresis_mode=mode, device="cpu", backend=backend)
    np.testing.assert_array_equal(model(frames[0], 30, 90).numpy(),
                                  np.asarray(ref(frames[0], 30, 90)))
    np.testing.assert_array_equal(model.batch(frames, 30, 90).numpy(),
                                  np.asarray(ref.batch(frames, 30, 90)))
    np.testing.assert_array_equal(model.packed(frames[1], 30, 90).numpy(),
                                  np.asarray(ref.packed(frames[1], 30, 90)))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_model_backends_agree_with_fused(backend, test_image):
    fused = CannyTorch.from_numpy_params(gaussian_kernel(1.0), device="cpu")
    model = CannyTorch.from_numpy_params(gaussian_kernel(1.0), device="cpu",
                                         backend=backend)
    assert model.backend == backend
    np.testing.assert_array_equal(model(test_image, 50, 150).numpy(),
                                  fused(test_image, 50, 150).numpy())
    np.testing.assert_array_equal(model(test_image, 50, 150).numpy(),
                                  golden.canny(test_image, 1.0, 50, 150))
