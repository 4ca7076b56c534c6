"""pad_ms.serve: host ms of the serving engine's `dqrm.serve.pad` span
per device batch in the traced stretch (`phases.mean_ms`)."""

import phases


def read(record):
    return phases.serve_ms(record, "pad")
