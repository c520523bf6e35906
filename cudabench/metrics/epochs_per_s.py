"""`epochs_per_s`: scenario-epochs completed in the measured window, over
the window's host-clock seconds (from the first call's start to the last
call's end, every call ending with its results on the host)."""


def read(window):
    if not window.spans:
        return None
    return len(window.spans) * window.work_per_call / window.seconds
