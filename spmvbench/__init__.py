"""spmvbench: the benchmark of ``tpu_spmv_torch`` on one card or four.

    python3 -m spmvbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything it needs is found by name from ``BENCHMARK.json`` (see
``spmvbench/README.md``).  It imports nothing at package import: the
harness lives in :mod:`spmvbench.run`.
"""
