"""`setup_s`: seconds from the start of the run to the start of the
measured window: the interpreter's imports, the CUDA context, the inputs
made from the seed and uploaded, the kernel libraries built or loaded, and
the warm-up call."""


def read(window):
    return window.setup_s
