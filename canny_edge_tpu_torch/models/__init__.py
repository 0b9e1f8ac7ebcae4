from .canny import CannyTorch
from .sobel import SobelTorch

__all__ = ["CannyTorch", "SobelTorch"]
