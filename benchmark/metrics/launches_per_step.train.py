"""launches_per_step.train: device operations (kernels, copies, sets) in the
traced megasteps, over their steps."""

import tracing


def read(record):
    traced = record.get("traced")
    if not traced:
        return None
    ops = tracing.in_stretch(traced["trace"])
    return len(ops) / traced["steps"] if ops else None
