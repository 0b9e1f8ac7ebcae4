"""Plain PyTorch ops: Gaussian taps, the front end and the packed flood."""
