from . import imageio, video  # noqa: F401
from .imageio import (  # noqa: F401
    bgr_to_gray,
    load_grayscale,
    minmax_normalize_u8,
    save_png,
    synthetic_image,
)
from .video import batched, open_source  # noqa: F401
