"""The benchmark's frames: the headline pattern (a sinusoid, a bright disc
and Gaussian noise; ``bench_torch.py:make_image``), varied per frame from
the seed and made where the frames are served.

Every frame of a pool has the one shape of its configuration, and shows
the one scene whatever that shape: the sinusoid's periods and the noise's
grain are those of ``make_image`` at the configuration's ``scene_width``
and scale with ``width / scene_width``, as the disc does with the frame, so
a 4K frame is the 1080p scene at twice the size.  The seed draws, per
frame, the phases of the sinusoid and the centre and radius of
the disc (:func:`frame_params`, on the host, NumPy's generator) and the
noise (a ``torch.Generator`` on the pool's device, in a few large calls).
So a seed changes what the frames show and never their number or size.
A configuration's frame type sets the scene's white level: its levels are
those of ``make_image`` (a white level of 255) scaled to the level it
states, so a 16-bit frame shows the 8-bit scene with finer steps.
Imports only NumPy and PyTorch: nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

# the pattern of ``make_image`` at its scene width: 96 + 64 sin(x / 17)
# cos(y / 23), a disc of +80 whose radius is a third of the shorter side,
# noise of deviation 6 a pixel
BASE, AMPLITUDE, PERIOD_X, PERIOD_Y = 96.0, 64.0, 17.0, 23.0
DISC, NOISE = 80.0, 6.0
CHUNK_BYTES = 1 << 29     # float32 bytes of frames made in one call


def frame_params(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """``(n, 5)`` float64: per frame the sinusoid's phase in x and in y, the
    disc's centre (row, column) within the middle third of the frame and its
    radius, 0.8 to 1.2 times a third of the shorter side.  ``seed``: any
    whole number, past 64 bits too."""
    rng = np.random.default_rng(abs(int(seed)))
    phase = rng.uniform(0.0, 2.0 * math.pi, size=(n, 2))
    cy = rng.uniform(h / 3.0, 2.0 * h / 3.0, size=n)
    cx = rng.uniform(w / 3.0, 2.0 * w / 3.0, size=n)
    r = rng.uniform(0.8, 1.2, size=n) * min(h, w) / 3.0
    return np.column_stack([phase, cy, cx, r])


def noise_seed(seed: int) -> int:
    """The seed of the noise generator, drawn from ``seed``."""
    return int(np.random.default_rng([1, abs(int(seed))]).integers(1, 2**62))


def make_pool(params: np.ndarray, h: int, w: int, seed: int, device,
              scene_width: int, dtype: str = "uint8", full_scale: int = 255):
    """One ``(h, w)`` frame of ``dtype`` (``"uint8"`` or ``"uint16"``) a
    row of ``params`` (:func:`frame_params`), as an ``(n, h, w)`` tensor
    made on ``device`` with the noise of ``seed``; the scene is
    ``make_image``'s at ``scene_width``, scaled by ``w / scene_width``, its
    levels by ``full_scale / 255``, clipped to ``[0, full_scale]``.  At
    uint8 and 255 the levels are ``make_image``'s own (a factor of exactly
    1.0)."""
    import torch

    n = params.shape[0]
    scale = w / scene_width
    level = full_scale / 255.0
    base, amplitude = BASE * level, AMPLITUDE * level
    disc, noise_sd = DISC * level, NOISE * level
    # the noise is drawn on the scene's grid and each pixel takes the
    # sample of the scene pixel it lies in
    gh, gw = math.ceil(h / scale), math.ceil(w / scale)
    iy = (torch.arange(h, device=device) / scale).long().clamp_(max=gh - 1)
    ix = (torch.arange(w, device=device) / scale).long().clamp_(max=gw - 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed(seed))
    pool = torch.empty((n, h, w), dtype=getattr(torch, dtype),
                       device=device)
    yy = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w)
    chunk = max(1, CHUNK_BYTES // (4 * h * w))
    for s in range(0, n, chunk):
        p = torch.as_tensor(params[s:s + chunk], dtype=torch.float32,
                            device=device)
        c = p.shape[0]
        px, py, cy, cx, r = (p[:, k].view(c, 1, 1) for k in range(5))
        img = base + amplitude * torch.sin(xx / (PERIOD_X * scale) + px) \
            * torch.cos(yy / (PERIOD_Y * scale) + py)
        img = img + disc * (((xx - cx) ** 2 + (yy - cy) ** 2) < r * r)
        noise = torch.randn((c, gh, gw), generator=gen, device=device)
        if (gh, gw) != (h, w):
            noise = noise[:, iy][:, :, ix]
        img = img + noise_sd * noise
        # clip, then truncate toward zero, as NumPy's astype(uint8) does
        pool[s:s + c] = img.clamp_(0.0, float(full_scale)).to(pool.dtype)
    return pool
