"""update_launches.train: CUDA runtime calls that enqueue device work inside
the train step's `dqrm.train.update` spans, over the traced steps
(`phases.launches`)."""

import phases


def read(record):
    return phases.train_launches(record, "update")
