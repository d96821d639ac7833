"""tpu_spmv_torch — the PyTorch/CUDA port of ``tpu_spmv``.

CSR SpMV through every route of the JAX package's CSR dispatch (the packed
window-ELL plan, with block reordering, bf16 value streams and the pattern
fast path; row-banded, column-strip and composite stacks of it; the naive
SCALAR_CSR plan; the flat path), ELL SpMV through the JAX ELL dispatch (a
window-ELL plan of its CSR form, column strips, the slot-major flat path),
plan files in the JAX package's format, the benchmark harness, Matrix
Market IO, a demo (``python -m tpu_spmv_torch.cli``), and PageRank on
top: planned on the host
in NumPy and run by hand-written CUDA kernels for ``sm_90a`` (the fold, the
row unpermute and the chunk permute), on the card unless the caller names another device.  It imports torch and
NumPy, never JAX.  Importing it builds nothing: the planner library and the
CUDA kernels are compiled on first use.
"""

from .errors import (
    DeviceException,
    FileIOError,
    InvalidArgumentError,
    InvalidDimensionError,
    InvalidFormatError,
    SpMVError,
    SpMVException,
    spmv_error_string,
)
from .csr import (
    CSRMatrix,
    CSRStats,
    DeviceCSR,
    csr_compute_stats,
    csr_create,
    csr_deserialize,
    csr_from_dense,
    csr_get_element,
    csr_serialize,
    csr_to_dense,
    csr_to_device,
)
from .ell import (
    DeviceELL,
    ELLMatrix,
    ell_create,
    ell_deserialize,
    ell_from_csr,
    ell_from_dense,
    ell_get_element,
    ell_index,
    ell_serialize,
    ell_to_dense,
    ell_to_device,
)
from .buffer import DeviceBuffer
from .ops import spmv_cpu_csr, spmv_cpu_ell
from .spmv import (
    KernelType,
    SpMVConfig,
    SpMVResult,
    spmv_csr,
    spmv_ell,
    spmv_validate_dimensions,
)
from .selector import spmv_auto_config
from .bandwidth import (
    BandwidthMetrics,
    compute_bandwidth_csr,
    compute_bandwidth_ell,
    get_gpu_peak_bandwidth,
)
from .benchmark import (
    BenchmarkConfig,
    BenchmarkResult,
    ComparisonResult,
    benchmark_csr,
    benchmark_ell,
    benchmark_from_json,
    benchmark_to_json,
    compare_gpu_cpu_csr,
    comparison_to_json,
)
from .io import load_matrix_market, save_matrix_market
from .plan_io import load_plan, save_plan
from . import profiling
from .pagerank import (
    PageRankConfig,
    PageRankResult,
    TopKNode,
    pagerank,
    pagerank_load_state,
    pagerank_save_state,
    pagerank_top_k,
)

__version__ = "0.3.0"  # the JAX package's version

__all__ = [
    "SpMVError", "SpMVException", "DeviceException", "FileIOError",
    "InvalidArgumentError", "InvalidDimensionError", "InvalidFormatError",
    "spmv_error_string",
    "CSRMatrix", "CSRStats", "DeviceCSR",
    "csr_create", "csr_from_dense", "csr_to_dense", "csr_get_element",
    "csr_to_device", "csr_serialize", "csr_deserialize", "csr_compute_stats",
    "ELLMatrix", "DeviceELL", "ell_index",
    "ell_create", "ell_from_dense", "ell_from_csr", "ell_to_dense",
    "ell_get_element", "ell_to_device", "ell_serialize", "ell_deserialize",
    "DeviceBuffer", "spmv_cpu_csr", "spmv_cpu_ell",
    "KernelType", "SpMVConfig", "SpMVResult",
    "spmv_csr", "spmv_ell", "spmv_validate_dimensions", "spmv_auto_config",
    "BandwidthMetrics", "compute_bandwidth_csr", "compute_bandwidth_ell",
    "get_gpu_peak_bandwidth",
    "BenchmarkConfig", "BenchmarkResult", "ComparisonResult",
    "benchmark_csr", "benchmark_ell", "compare_gpu_cpu_csr",
    "benchmark_to_json", "benchmark_from_json", "comparison_to_json",
    "load_matrix_market", "save_matrix_market", "save_plan", "load_plan",
    "PageRankConfig", "PageRankResult", "TopKNode", "pagerank",
    "pagerank_top_k", "pagerank_save_state", "pagerank_load_state",
    "profiling",
]
