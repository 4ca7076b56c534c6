"""serve_p95_ms: the 95th percentile of the latency of every request sent in
the window, those answered after the close included, from the caller's send
to its result."""

import numpy as np


def read(record):
    lat = record["window"]["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None
