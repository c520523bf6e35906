"""`device_idle_pct`: the share of the traced window in which no operation
(kernel, copy or fill) ran on the device, from the union of the device
intervals in the profiler's trace."""


def read(window):
    trace = window.trace
    if trace is None or trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
