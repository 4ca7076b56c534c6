"""mfu.train: the least time of the window's steps (roofline.train_steps:
the MLPs' and the interaction's operations at the tensor-core peak, or the
bytes the steps must move at the memory's, whichever is longer) over the
window's time, in percent."""

import roofline


def read(record):
    w = record["window"]
    if not w["steps"]:
        return None
    least = roofline.train_steps(record["model"], record["quant"], record["traffic"]["batch"], w["steps"],
                                 w["touched_rows"])
    return roofline.share(least["least_s"], w["seconds"])
