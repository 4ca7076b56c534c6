"""serve_preds_per_s: the rows of every request answered inside the window
over the window's time."""


def read(record):
    w = record["window"]
    return w["rows_answered"] / w["seconds"]
