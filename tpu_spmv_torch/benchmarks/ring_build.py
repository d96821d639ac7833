"""The ring sharding's build cost against the mesh size (port of
``benchmarks/ring_build.py``).

    python3 -m tpu_spmv_torch.benchmarks.ring_build [--rows N]
        [--sizes 4 8 16 32] [--device cpu] [--out FILE]

The ring form builds n·(n-1) block-pair plans and pads ``pack_idx`` to the
widest packed footprint, so its cost grows with the square of the mesh.
For each mesh size n (every shard on the one device: ``make_row_mesh(n,
devices=[device] * n)``; the ring cap ``TPU_SPMV_RING_MAX`` lifted to the
largest size) on ``web_graph_csr(N, N, avg 12)``: the build's wall
seconds, the bytes of every tensor it holds, the packed footprints, the
ring's byte model, and the SpMV held to the CPU oracle at rel 1e-5 (a
size where a block pair packs in no layout is reported as such).  The
JAX script stacks and pads the shard plans for ``shard_map``; the port
keeps each plan at its own size, so its bytes are not the JAX ones.  One
JSON object on stdout, ``device`` and a row a size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..bench import log
from ..errors import guarded_upload, target_device
from ..kernels.plan import WindowEllOverflow
from ..parallel import (make_row_mesh, ring_traffic_report, shard_csr_ring,
                        spmv_csr_ring)
from ..soak import env
from ..utils.testing import RandomGenerator, spmv_matches, web_graph_csr

REL_TOL = 1e-5


def tensor_bytes(obj) -> int:
    """Bytes of every tensor reachable through dataclass fields, tuples and
    lists."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def ring_row(csr, x, n: int, device: torch.device) -> dict:
    mesh = make_row_mesh(n, devices=[device] * n)
    t0 = time.time()
    try:
        rs = shard_csr_ring(csr, mesh)
    except WindowEllOverflow as e:
        log(f"n={n}: a block pair packs in no layout ({e})")
        return {"n": n, "overflow": str(e)}
    build_s = time.time() - t0
    y = spmv_csr_ring(rs, guarded_upload(x, device), mesh)
    ok = spmv_matches(y.cpu().numpy(), csr, x, rel_tol=REL_TOL)
    traffic = ring_traffic_report(rs)
    row = {"n": n, "build_s": round(build_s, 1), "plan_count": n * n,
           "tensor_bytes": tensor_bytes(rs), "u_max": rs.u_max,
           "pack_len": list(rs.pack_len), "correct": bool(ok),
           "ring_bytes": traffic.get("ring_bytes"),
           "replicate_bytes": traffic.get("replicate_bytes"),
           "compression": traffic.get("compression")}
    log(f"n={n}: build {build_s:.1f}s tensors "
        f"{row['tensor_bytes']/1e9:.2f} GB u_max={rs.u_max} correct={ok}")
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "tpu_spmv_torch.benchmarks.ring_build")
    p.add_argument("--rows", type=int, default=131072)
    p.add_argument("--sizes", type=int, nargs="*", default=[4, 8, 16, 32])
    p.add_argument("--device", default="cuda",
                   help="where to run: the card (default), or cpu")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this file")
    args = p.parse_args(argv)
    device = target_device(args.device, "ring_build")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    rng = RandomGenerator(42)
    csr = web_graph_csr(rng, args.rows, args.rows, avg_nnz=12.0)
    x = rng.vector(args.rows)
    log(f"matrix: {args.rows}^2 nnz={csr.nnz}; {name}")
    with env(TPU_SPMV_RING_MAX=max(args.sizes)):
        rows = [ring_row(csr, x, n, device) for n in args.sizes]
    report = {"device": name,
              "matrix": {"rows": args.rows, "nnz": csr.nnz,
                         "kind": "web_graph avg=12"},
              "policy": "shard_csr_ring raises WindowEllOverflow past "
                        "TPU_SPMV_RING_MAX (default 16); callers take the "
                        "replicated-packed form (O(n) plans)",
              "rows": rows}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if all(r.get("correct", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
