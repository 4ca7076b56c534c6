"""pointwise_ms.train: device ms a step of the traced megasteps' device ops
in the class `pointwise` of `kernel_classes`: every other op (elementwise
and reduction kernels, as the fake-quant's passes and the optimizer; sorts,
copies, fills)."""

import kernel_classes


def read(record):
    return kernel_classes.train_ms(record, "pointwise")
