"""backward_idle_ms.train: the device's idle ms inside the train step's
`dqrm.train.backward` spans, over the traced steps (`phases.idle_us`)."""

import phases


def read(record):
    return phases.train_idle_ms(record, "backward")
