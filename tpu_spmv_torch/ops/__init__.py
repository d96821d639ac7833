from .cpu_reference import spmv_cpu_csr, spmv_cpu_ell

__all__ = ["spmv_cpu_csr", "spmv_cpu_ell"]
