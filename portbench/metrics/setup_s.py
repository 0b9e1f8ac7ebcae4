"""``setup_s`` (s, host clock): from the process's start to the start of
the window: the interpreter, PyTorch, the card's context, the kernels'
libraries (built on a checkout's first run, loaded after), the pool and
the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
