"""graph_step_share.train: the share of the traced megasteps' steps that the
train step's CUDA graph took: its `dqrm.train.graph` spans (one a replayed
step) in the traced stretch over the stretch's steps, in percent
(`phases.spans`). None where the trace has no device ops or no such span (a
program that replays no graph)."""

import phases


def read(record):
    traced = record.get("traced")
    if not traced or not traced["trace"].device_ops:
        return None
    n = len(phases.spans(traced["trace"], "dqrm.train.graph"))
    return 100.0 * n / traced["steps"] if n else None
