"""k1_bags_roofline.train: K1 (`dense_grad_grouped_kernel`) in the traced
megasteps of a model with bags of per-table widths: its least time per
launch at the cell's shapes (roofline_dcn.k1_step) times its launches, over
its device time, in percent."""

import roofline
import roofline_dcn
import tracing

KERNEL = "dense_grad_grouped_kernel"


def read(record):
    traced = record.get("traced")
    if not traced or "multi_hot_sizes" not in record["model"]:
        return None
    dev_s, launches = roofline.kernel_device_s(tracing.in_stretch(traced["trace"]), KERNEL)
    if not launches:
        return None
    least = roofline_dcn.k1_step(record["model"], record["train"], record["traffic"]["batch"])["least_s"]
    return roofline.share(least * launches, dev_s)
