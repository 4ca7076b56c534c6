"""pad_waste_share.serve: the padding rows the engine added to reach its
bucket sizes, over the rows of the device batches, in the window, in
percent."""


def read(record):
    w = record["window"]
    if not w["bucket_rows"]:
        return None
    return 100.0 * (w["bucket_rows"] - w["asked_rows"]) / w["bucket_rows"]
