"""tpu_spmv_torch — the PyTorch/CUDA port of ``tpu_spmv``.

The port's first slice: merge-path (and vector) CSR SpMV through the packed
window-ELL plan, planned on the host in NumPy and run by two hand-written
CUDA kernels for ``sm_90a`` (the fold and the row unpermute).  It imports
torch and NumPy, never JAX.  Importing it builds nothing: the planner
library and the CUDA kernels are compiled on first use.
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

__all__ = [
    "SpMVError", "SpMVException", "DeviceException",
    "InvalidArgumentError", "InvalidDimensionError", "InvalidFormatError",
    "spmv_error_string",
    "CSRMatrix", "CSRStats", "spmv_cpu_csr",
    "KernelType", "SpMVConfig", "SpMVResult",
    "spmv_csr", "spmv_validate_dimensions", "spmv_auto_config",
    "BandwidthMetrics", "compute_bandwidth_csr",
]
