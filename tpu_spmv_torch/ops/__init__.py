from .cpu_reference import spmv_cpu_csr

__all__ = ["spmv_cpu_csr"]
