"""train_samples_per_s: every sample of the steps run in the window over the
window's time (a synchronize opens and closes it)."""


def read(record):
    w = record["window"]
    return w["samples"] / w["seconds"]
