"""device_idle_share.train: the share of the traced megasteps' wall time in
which no device operation ran, in percent."""

import tracing


def read(record):
    traced = record.get("traced")
    if not traced or not traced["trace"].device_ops:
        return None
    tr = traced["trace"]
    return 100.0 * (1.0 - tracing.busy_s(tr) / tr.wall_s)
