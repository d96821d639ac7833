"""Kernel auto-selector (port of ``tpu_spmv/selector.py``, unchanged):
near-empty → scalar, low skew → vector, high skew → merge-path."""

from __future__ import annotations

from .csr import CSRMatrix
from .spmv import KernelType, SpMVConfig

AVG_NNZ_SCALAR_THRESHOLD = 0.05
SKEWNESS_VECTOR_THRESHOLD = 4.0
DEFAULT_BLOCK_SIZE = 256


def spmv_auto_config(A: CSRMatrix) -> SpMVConfig:
    """Pick a kernel configuration from row statistics
    (reference ``spmv_auto_config``, ``spmv_cpu.cpp:34-50``)."""
    config = SpMVConfig()
    config.block_size = DEFAULT_BLOCK_SIZE
    config.use_vmem_x = True

    stats = A.compute_stats()

    if stats.avg_nnz_per_row < AVG_NNZ_SCALAR_THRESHOLD:
        config.kernel_type = KernelType.SCALAR_CSR
    elif stats.skewness < SKEWNESS_VECTOR_THRESHOLD:
        config.kernel_type = KernelType.VECTOR_CSR
    else:
        config.kernel_type = KernelType.MERGE_PATH

    return config
