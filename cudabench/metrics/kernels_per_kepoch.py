"""`kernels_per_kepoch`: CUDA kernels the device executed in the traced
window (copies and fills not counted) per 1000 scenario-epochs the traced
calls completed: the host driver's and the wrappers' launch count, the
phase kernels' and PyTorch's alike."""


def read(window):
    trace = window.trace
    kernels = trace.kernels() if trace is not None else []
    if not kernels:
        return None
    return 1000.0 * len(kernels) / (trace.calls * window.work_per_call)
