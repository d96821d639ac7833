"""Row-sharded SpMV over 1, 2, 4, ... devices: nnz/s and its efficiency
(port of ``benchmarks/scaling.py``).

    python3 -m tpu_spmv_torch.benchmarks.scaling [--rows N] [--cols N]
        [--avg-nnz K] [--structure powerlaw|local] [--cpu-devices N]
        [--json] [--out FILE]

For each device count (the cards present: 1, 2, 4, ... up to
``torch.cuda.device_count()``; with ``--cpu-devices N``, meshes of up to N
CPU shards, ``make_row_mesh(d, devices=["cpu"] * d)``) the matrix is
sharded by nnz-balanced rows, packed (``shard_csr_packed``; where the
packed layout rejects a shard, ``WindowEllOverflow``, the flat shards of
``shard_csr``: the dispatch's route choice, named in each row's
``route``), checked against the CPU oracle and timed over 100 calls.  The
ring path, leveled shards and the pattern path on a column-scaled twin are
checked too (``None`` where the packed layout rejects them), and the
ring's byte model reported.  ``efficiency_wall`` is ``None`` on a CPU mesh,
whose shards run one after another in one process; ``efficiency_balance``
(mean over max shard nnz) is the work-balance bound.

With one card it prints one row, its JSON noting that scaling needs more
cards.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..bench import Clock, log
from ..csr import CSRMatrix
from ..errors import DeviceAllocError, guarded_upload
from ..kernels.plan import WindowEllOverflow
from ..parallel import (make_row_mesh, ring_traffic_report, shard_csr,
                        shard_csr_packed, shard_csr_ring, spmv_csr_ring,
                        spmv_csr_sharded, spmv_csr_sharded_packed)
from ..utils.testing import RandomGenerator, spmv_matches

ITERS = 100
REL_TOL = 1e-5
COUNTS = (1, 2, 4, 8, 16, 32)
ONE_DEVICE = "one device, one row: no scaling measured (it needs more cards)"


def local_csr(rng: RandomGenerator, rows: int, cols: int,
              avg_nnz: float) -> CSRMatrix:
    """``--structure local``: each row's columns within ±2% of the
    diagonal's (at least ±64), the JAX script's draws."""
    half = max(64, int(cols * 0.02))
    k = max(1, int(avg_nnz))
    base_r = np.repeat(np.arange(rows, dtype=np.int64), k)
    off = rng.rng.integers(-half, half + 1, size=len(base_r))
    cc = np.clip((base_r * cols) // rows + off, 0, cols - 1)
    order = np.lexsort((cc, base_r))
    rp = np.zeros(rows + 1, np.int32)
    np.cumsum(np.bincount(base_r, minlength=rows), out=rp[1:])
    return CSRMatrix(rows, cols, rng.vector(len(base_r)).astype(np.float32),
                     cc[order].astype(np.int32), rp)


def _ok(y: torch.Tensor, A: CSRMatrix, x: np.ndarray) -> bool:
    return bool(spmv_matches(y.cpu().numpy(), A, x, rel_tol=REL_TOL))


def scaling_row(A: CSRMatrix, x: np.ndarray, mesh, rng: RandomGenerator,
                clock: Clock, base: float | None,
                iters: int = ITERS) -> dict:
    """One device count's row (``scaling.py:92-170``); ``base`` is the
    one-device nnz/s (``None`` for that row itself)."""
    d = mesh.n_shards
    try:
        sharded, run, route = shard_csr_packed(A, mesh), \
            spmv_csr_sharded_packed, "packed"
    except WindowEllOverflow:
        sharded, run, route = shard_csr(A, mesh), spmv_csr_sharded, "flat"
    xd = guarded_upload(x, mesh.home)
    ok = _ok(run(sharded, xd, mesh), A, x)
    secs = clock.seconds(lambda: run(sharded, xd, mesh), iters)
    nnz_s = A.nnz / secs
    cpu_mesh = mesh.home.type == "cpu"
    eff = None if cpu_mesh else nnz_s / ((base or nnz_s) * d)
    imb = sharded.nnz_imbalance
    try:
        rs = shard_csr_ring(A, mesh)
        ring_ok, traffic = _ok(spmv_csr_ring(rs, xd, mesh), A, x), \
            ring_traffic_report(rs)
    except WindowEllOverflow:
        ring_ok, traffic = None, None
    try:
        sl = shard_csr_packed(A, mesh, permute_rows=True)
        lv_ok = _ok(spmv_csr_sharded_packed(sl, xd, mesh), A, x)
    except WindowEllOverflow:
        lv_ok = None
    s_col = np.abs(rng.vector(A.num_cols)) + 0.5
    twin = CSRMatrix(A.num_rows, A.num_cols, s_col[A.col_indices],
                     A.col_indices, A.row_ptrs)
    try:
        st = shard_csr_packed(twin, mesh, pattern=True)
        pt_ok = _ok(spmv_csr_sharded_packed(st, xd, mesh), twin, x)
    except WindowEllOverflow:
        pt_ok = None
    row = {"devices": d, "route": route, "gnnz_per_s": nnz_s / 1e9,
           "efficiency_wall": eff, "efficiency_balance": 1.0 / (1.0 + imb),
           "nnz_imbalance": imb, "correct": ok, "ring_correct": ring_ok,
           "leveled_correct": lv_ok, "pattern_correct": pt_ok,
           "ring_traffic": traffic}
    comp = "n/a" if not traffic \
        else f"{traffic['compression']:.2f}x compression"
    log(f"  {d:2d} dev ({route}): {secs*1e6:9.1f} us  {nnz_s/1e9:7.2f} "
        f"Gnnz/s  eff(wall) {'n/a' if eff is None else f'{eff:5.2f}'}  "
        f"eff(balance) {row['efficiency_balance']:5.2f}  imbalance "
        f"{imb:5.1%}  correct={ok}  ring={ring_ok} ({comp})  "
        f"leveled={lv_ok}  pattern={pt_ok}")
    return row


def sweep(A: CSRMatrix, x: np.ndarray, counts: list, mesh_of,
          rng: RandomGenerator, clock: Clock, iters: int = ITERS) -> list:
    """The rows for each device count of ``counts``, ``mesh_of(d)`` giving
    the mesh."""
    rows, base = [], None
    for d in counts:
        row = scaling_row(A, x, mesh_of(d), rng, clock, base, iters)
        base = base or row["gnnz_per_s"] * 1e9
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.benchmarks.scaling")
    p.add_argument("--rows", type=int, default=262144)
    p.add_argument("--cols", type=int, default=None)
    p.add_argument("--avg-nnz", type=float, default=16.0)
    p.add_argument("--structure", choices=("powerlaw", "local"),
                   default="powerlaw",
                   help="'local': banded row locality, where the ring "
                        "path's footprint compression wins")
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="meshes of up to N CPU shards instead of the cards")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this file")
    args = p.parse_args(argv)
    if args.cpu_devices:
        n_dev = args.cpu_devices
        clock = Clock(torch.device("cpu"), None)

        def mesh_of(d):
            return make_row_mesh(d, devices=["cpu"] * d)
    else:
        if not torch.cuda.is_available():
            raise DeviceAllocError("scaling: no CUDA device is available "
                                   "(--cpu-devices N runs CPU shards)")
        n_dev = torch.cuda.device_count()
        clock = Clock.on(torch.device("cuda", 0))
        mesh_of = make_row_mesh
    cols = args.cols or min(args.rows, 4096)
    rng = RandomGenerator(42)
    if args.structure == "local":
        A = local_csr(rng, args.rows, cols, args.avg_nnz)
    else:
        A = rng.power_law_csr(args.rows, cols, avg_nnz=args.avg_nnz,
                              alpha=1.6)
    x = rng.vector(cols)
    log(f"devices: {n_dev} x {clock.name}; matrix {args.rows}x{cols} "
        f"nnz={A.nnz}")
    counts = [d for d in COUNTS if d <= n_dev]
    rows = sweep(A, x, counts, mesh_of, rng, clock)
    out = {"device": clock.name, "devices": n_dev, "rows": args.rows,
           "nnz": A.nnz, "structure": args.structure, "results": rows}
    if counts == [1]:
        out["note"] = ONE_DEVICE
        log(ONE_DEVICE)
    if args.json:
        print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if all(r["correct"] and False not in (
        r["ring_correct"], r["leveled_correct"], r["pattern_correct"])
        for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
