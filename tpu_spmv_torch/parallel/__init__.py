"""Row-sharded multi-device SpMV and PageRank (port of ``tpu_spmv.parallel``)."""

from .distributed import (
    RingShardedCSR,
    ShardedCSR,
    ShardedWindowEll,
    init_distributed,
    make_row_mesh,
    pagerank_sharded,
    pagerank_step_sharded,
    ring_traffic_report,
    shard_csr,
    shard_csr_packed,
    shard_csr_ring,
    spmv_csr_ring,
    spmv_csr_sharded,
    spmv_csr_sharded_packed,
)

__all__ = [
    "RingShardedCSR",
    "ShardedCSR",
    "ShardedWindowEll",
    "init_distributed",
    "make_row_mesh",
    "pagerank_sharded",
    "pagerank_step_sharded",
    "ring_traffic_report",
    "shard_csr",
    "shard_csr_packed",
    "shard_csr_ring",
    "spmv_csr_ring",
    "spmv_csr_sharded",
    "spmv_csr_sharded_packed",
]
