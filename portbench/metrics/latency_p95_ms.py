"""latency_p95_ms: the 95th percentile, over every call of the timed
window, of the host-clock time from handing two uint8 frames to the
program to holding the uint8 middle frame; a failed call counts as
missing (infinitely late). Pair traffic only."""
import math

import numpy as np


def read(run):
    lat = run.window.latencies_s
    if not lat:
        return None
    v = float(np.percentile(np.asarray(lat, dtype=np.float64), 95))
    return v * 1e3 if math.isfinite(v) else None
