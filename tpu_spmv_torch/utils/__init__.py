from .testing import RandomGenerator, spmv_matches, spmv_rel_equal

__all__ = ["RandomGenerator", "spmv_matches", "spmv_rel_equal"]
