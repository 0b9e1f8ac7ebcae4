"""The benchmark's yardstick: the frozen NumPy oracle (``oracle``), the
comparison that decides ``correct`` (``compare``) and the frame generator
(``frames``).  Nothing here imports the program, JAX or the JAX package."""
