"""gemm_ms.train: device ms a step of the traced megasteps' device ops in
the class `gemm` of `kernel_classes`: matrix products (cuBLAS and CUTLASS
kernels, the interaction's bmm, K3)."""

import kernel_classes


def read(record):
    return kernel_classes.train_ms(record, "gemm")
