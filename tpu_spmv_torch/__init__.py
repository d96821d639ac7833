"""tpu_spmv_torch — the PyTorch/CUDA port of ``tpu_spmv``.

Merge-path (and vector) CSR SpMV through the packed window-ELL plan, with
block reordering, bf16 value streams and the pattern fast path, and
PageRank on top: planned on the host in NumPy and run by hand-written CUDA
kernels for ``sm_90a`` (the fold, the row unpermute and the chunk permute),
on the card unless the caller names another device.  It imports torch and
NumPy, never JAX.  Importing it builds nothing: the planner library and the
CUDA kernels are compiled on first use.
"""

from .errors import (
    DeviceException,
    InvalidArgumentError,
    InvalidDimensionError,
    InvalidFormatError,
    SpMVError,
    SpMVException,
    spmv_error_string,
)
from .csr import CSRMatrix, CSRStats
from .ops import spmv_cpu_csr
from .spmv import (
    KernelType,
    SpMVConfig,
    SpMVResult,
    spmv_csr,
    spmv_validate_dimensions,
)
from .selector import spmv_auto_config
from .bandwidth import BandwidthMetrics, compute_bandwidth_csr
from .pagerank import (
    PageRankConfig,
    PageRankResult,
    TopKNode,
    pagerank,
    pagerank_load_state,
    pagerank_save_state,
    pagerank_top_k,
)

__all__ = [
    "SpMVError", "SpMVException", "DeviceException",
    "InvalidArgumentError", "InvalidDimensionError", "InvalidFormatError",
    "spmv_error_string",
    "CSRMatrix", "CSRStats", "spmv_cpu_csr",
    "KernelType", "SpMVConfig", "SpMVResult",
    "spmv_csr", "spmv_validate_dimensions", "spmv_auto_config",
    "BandwidthMetrics", "compute_bandwidth_csr",
    "PageRankConfig", "PageRankResult", "TopKNode", "pagerank",
    "pagerank_top_k", "pagerank_save_state", "pagerank_load_state",
]
