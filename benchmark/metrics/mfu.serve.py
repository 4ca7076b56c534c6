"""mfu.serve: the least time to answer the useful rows of the traced
stretch's device batches (roofline.serve_batches: the forward's operations
at the tensor-core peak, or the inputs, distinct packed-row sectors,
outputs and the weights once a batch at the memory's peak, whichever is
longer) over the stretch's wall time, in percent."""

import roofline


def read(record):
    traced = record.get("traced")
    if not traced or not traced["useful_ids"]:
        return None
    least = roofline.serve_batches(record["model"], record["serve"], traced["useful_ids"])
    return roofline.share(least["least_s"], traced["trace"].wall_s)
