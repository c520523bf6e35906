"""`call_p90_ms`: the 90th percentile of the host-clock times of every
call in the window (linear interpolation between the closest ranks), in
ms: the time one user waits for one study."""

import numpy as np


def read(window):
    if not window.spans:
        return None
    return float(np.percentile([(t1 - t0) * 1e3 for t0, t1 in window.spans], 90))
