from .testing import (
    RandomGenerator,
    float_arrays_equal,
    generate_random_csr,
    generate_random_dense_matrix,
    generate_random_vector,
    int_arrays_equal,
    spmv_matches,
    spmv_rel_equal,
)

__all__ = [
    "RandomGenerator",
    "float_arrays_equal",
    "generate_random_csr",
    "generate_random_dense_matrix",
    "generate_random_vector",
    "int_arrays_equal",
    "spmv_matches",
    "spmv_rel_equal",
]
