"""mfu_dcn.train: the least time of the window's DLRM-DCNv2 steps
(roofline_dcn.train_steps: the cross network's and the MLPs' operations at
the tensor-core peak, or the bytes the steps must move at the memory's,
whichever is longer) over the window's time, in percent. None where the
record's model has no cross network."""

import roofline
import roofline_dcn


def read(record):
    w, model = record["window"], record["model"]
    if not w["steps"] or model.get("interaction") != "dcn":
        return None
    least = roofline_dcn.train_steps(model, record["quant"], record["traffic"]["batch"], w["steps"],
                                     w["touched_rows"])
    return roofline.share(least["least_s"], w["seconds"])
