from .canny import CannyTorch

__all__ = ["CannyTorch"]
