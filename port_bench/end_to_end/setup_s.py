"""From the process's start to the window's: imports, the CUDA context, the
kernels' builds or loads, the inputs and the warm-up calls."""


def read(w):
    return w.setup_s
