"""graph_batch_share.serve: the share of the traced stretch's device batches
that the serving engine's CUDA graphs answered: its `dqrm.serve.graph` spans
(one a replayed batch) in the traced stretch over the stretch's device
batches, in percent (`phases.spans`). None where the trace has no device ops
or no such span (an engine that replays no graph)."""

import phases


def read(record):
    traced = record.get("traced")
    if not traced or not traced["trace"].device_ops:
        return None
    n = len(phases.spans(traced["trace"], "dqrm.serve.graph"))
    return 100.0 * n / len(traced["batch_ids"]) if n else None
