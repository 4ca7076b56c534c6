"""k2_roofline.serve: K2 (`packed_pooled_lookup_kernel`) in the traced
stretch: the least time of each traced batch's lookups (roofline.k2_batch,
from the batch's ids), summed, over K2's device time, in percent."""

import roofline
import tracing

KERNEL = "packed_pooled_lookup_kernel"


def read(record):
    traced = record.get("traced")
    if not traced:
        return None
    dev_s, launches = roofline.kernel_device_s(tracing.in_stretch(traced["trace"]), KERNEL)
    if not launches:
        return None
    least = sum(roofline.k2_batch(record["model"], record["serve"]["emb_bits"], ids)["least_s"]
                for ids in traced["batch_ids"])
    return roofline.share(least, dev_s)
