"""gather_scatter_ms.train: device ms a step of the traced megasteps'
device ops in the class `gather_scatter` of `kernel_classes`: embedding row
traffic (gathers, index and scatter kernels, embedding_bag, K1, K2, K4, K5,
K6)."""

import kernel_classes


def read(record):
    return kernel_classes.train_ms(record, "gather_scatter")
