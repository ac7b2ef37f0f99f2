"""latency_p95_ms (ms, host clock): 95th percentile of the latency of
every frame due in the window, from its due time to its step's completion."""

import numpy as np


def read(rec):
    lat = rec.get("latency_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
