"""k3_roofline.serve: K3 (`int8_linear_tc_kernel`) in the traced
stretch: the least time of every layer of each traced batch at its padded
rows (roofline.k3_batch), summed, over K3's device time, in percent."""

import roofline
import tracing

KERNEL = "int8_linear_tc_kernel"


def read(record):
    traced = record.get("traced")
    if not traced:
        return None
    dev_s, launches = roofline.kernel_device_s(tracing.in_stretch(traced["trace"]), KERNEL)
    batches = [roofline.k3_batch(record["model"], ids.shape[1]) for ids in traced["batch_ids"]]
    if not launches:
        return None
    return roofline.share(sum(b["least_s"] for b in batches), dev_s)
