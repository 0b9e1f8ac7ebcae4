"""Image IO with the reference's semantics: the port's own copy of
``canny_edge_tpu/io/imageio.py``.

The reference loads images with OpenCV ``imread(..., IMREAD_GRAYSCALE)``
(tests/utils/test_utils.cpp:48-49) and converts camera frames with
``cvtColor(..., COLOR_BGR2GRAY)`` (src/main.cpp:113).  Readers and writers
are taken in the JAX package's order: OpenCV, then Pillow, then the standard
library, which reads and writes 8-bit grayscale PNG (``zlib``) and binary
PGM (P5, maxval 255, ``#`` comments in the header, as the native feeder
reads it).  Any other file without OpenCV or Pillow raises ``ValueError``;
a frame is never guessed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def load_grayscale(path: str) -> np.ndarray:
    """uint8 (H, W) grayscale, loaded as the reference loads it."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(f"cannot read image: {path}")
        return img.astype(np.uint8)
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("L"), np.uint8)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return read_png(data)
    if data.startswith(b"P5"):
        return read_pgm(data)
    raise ValueError(f"cannot read {path} without OpenCV or Pillow: the "
                     "built-in readers take 8-bit grayscale PNG and binary "
                     "PGM only")


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV COLOR_BGR2GRAY with its exact fixed-point rounding.

    y = (9798*R + 19235*G + 3735*B + 2^14) >> 15  (ITU-R BT.601 weights in
    Q15), bit-exact against cv2.cvtColor on uint8 inputs.
    """
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
    return y.astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` (clipped to uint8) to ``path``; ``.png`` is added to a
    path without an extension."""
    if not os.path.splitext(path)[1]:
        path = path + ".png"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if cv2 is not None:
        cv2.imwrite(path, arr)
    elif Image is not None:
        Image.fromarray(arr).save(path)
    else:
        ext = os.path.splitext(path)[1].lower()
        if ext not in (".png", ".pgm") or arr.ndim != 2:
            raise ValueError(f"cannot write {path} without OpenCV or "
                             "Pillow: the built-in writers take 2-D images "
                             "to .png or .pgm only")
        with open(path, "wb") as f:
            f.write(png_bytes(arr) if ext == ".png" else pgm_bytes(arr))


def minmax_normalize_u8(img: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 255] uint8 like the reference's ``-s`` view.

    ``normalize(src, dst, 0, 255, NORM_MINMAX)`` + ``convertTo(CV_8U)``
    (src/utils.cpp:444-445): [min, max] maps linearly onto [0, 255] with
    round-half-to-even; a constant image maps to 0.
    """
    a = img.astype(np.float64)
    lo, hi = a.min(), a.max()
    if hi == lo:
        return np.zeros(img.shape, np.uint8)
    scaled = (a - lo) * (255.0 / (hi - lo))
    return np.rint(scaled).astype(np.uint8)


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Deterministic structured test frame (gradients + disc + stripes).

    The JAX package's frame, bit for bit: the same float64 operations on
    each pixel, with the row and column terms computed once and broadcast
    (half the host time at 1080p)."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.float64)[:, None]
    xx = np.arange(w, dtype=np.float64)[None, :]
    img = 96 + 64 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    img += 80 * (((xx - w / 2) ** 2 + (yy - h / 2) ** 2) < (min(h, w) / 3) ** 2)
    img += 40 * ((xx + yy) % 97 < 31)
    img += rng.normal(0, 6, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# standard-library formats
# ---------------------------------------------------------------------------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def png_bytes(img: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit grayscale PNG of a uint8 (H, W) image: every row filter 0
    (none), one IDAT chunk compressed at zlib ``level`` (1 favours speed)."""
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_slow(kind: int, line: list, prev: list) -> list:
    """Filters 3 (average) and 4 (Paeth), one byte at a time."""
    out = [0] * len(line)
    for i, x in enumerate(line):
        a = out[i - 1] if i else 0
        b = prev[i]
        if kind == 3:
            out[i] = (x + ((a + b) >> 1)) & 255
            continue
        c = prev[i - 1] if i else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 255
    return out


def read_png(data: bytes) -> np.ndarray:
    """uint8 (H, W) from the bytes of an 8-bit grayscale, non-interlaced
    PNG (any row filter); anything else raises ``ValueError``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or \
                struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"PNG chunk {tag!r} is truncated or corrupt")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise ValueError(f"the built-in PNG reader takes 8-bit grayscale, "
                         f"non-interlaced images, not bit depth {depth}, "
                         f"colour type {color}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not "
                         f"{h * (w + 1)} for {h}x{w}")
    rows = raw.reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for r in range(h):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line, dtype=np.uint8)     # wraps mod 256
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.array(_unfilter_slow(kind, line.tolist(), prev.tolist()),
                           np.uint8)
        else:
            raise ValueError(f"PNG row {r} has unknown filter {kind}")
        out[r] = cur
        prev = out[r]
    return out


def pgm_bytes(img: np.ndarray) -> bytes:
    """A binary PGM (P5, maxval 255) of a uint8 (H, W) image."""
    h, w = img.shape
    return b"P5\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img).tobytes()


def read_pgm(data: bytes) -> np.ndarray:
    """uint8 (H, W) from the bytes of a binary PGM with maxval 255; header
    tokens may be separated by whitespace and ``#`` comment lines."""
    pos, tokens = 2, []
    if not data.startswith(b"P5"):
        raise ValueError("not a binary PGM (P5) file")
    while len(tokens) < 3:
        if pos >= len(data):
            raise ValueError("PGM header is truncated")
        c = data[pos:pos + 1]
        if c == b"#":
            end = data.find(b"\n", pos)
            pos = len(data) if end < 0 else end + 1
        elif c.isspace():
            pos += 1
        else:
            start = pos
            while pos < len(data) and data[pos:pos + 1].isdigit():
                pos += 1
            if pos == start:
                raise ValueError(f"PGM header has {c!r} where a number "
                                 "belongs")
            tokens.append(int(data[start:pos]))
    w, h, maxval = tokens
    if maxval != 255 or w < 1 or h < 1:
        raise ValueError(f"the built-in PGM reader takes maxval 255 and a "
                         f"non-empty image, not {w}x{h} maxval {maxval}")
    pos += 1                                  # one whitespace byte
    body = data[pos:pos + h * w]
    if len(body) != h * w:
        raise ValueError(f"PGM data holds {len(body)} bytes, not {h * w}")
    return np.frombuffer(body, np.uint8).reshape(h, w).copy()
