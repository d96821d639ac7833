"""The JAX repo's device benchmarks (``benchmarks/``), ported to the card:
each script a module run as ``python3 -m tpu_spmv_torch.benchmarks.<name>``,
on the card unless ``--device cpu`` is given (``scaling``: ``--cpu-devices
N``), writing a file only where ``--out`` names one, and naming its device
in every JSON it prints.

* :mod:`.fallback_bench`: the routes served where the single plan is not
  (composite, the naive SCALAR_CSR plan, column strips, the wide ELL
  route, the flat path);
* :mod:`.perf_properties`: the reference spec's two efficiency properties;
* :mod:`.model_grid`: the superblock selector against full builds at every
  legal height (host planning only);
* :mod:`.scaling`: the row-sharded paths over 1, 2, 4, ... devices;
* :mod:`.mtx_bench`: Matrix Market files written, read back and served;
* :mod:`.tune`: the planner's split and cap-margin sweep.

Each ``main`` is a thin shell over functions that take the matrices, which
the tests call at small sizes.  Timing goes through
:class:`tpu_spmv_torch.bench.Clock` (``timing.time_cuda`` on the card,
``timing.time_runs`` on the CPU), the physics guard with it.
"""

import json

from ..bench import Clock, check
from ..errors import target_device
from ..utils.testing import spmv_matches


def checked_seconds(what: str, call, A, x, stream_bytes: float, clock,
                    iters: int, rel_tol: float = 1e-5) -> float:
    """``call()`` held to the CPU oracle on ``A`` and ``x`` (a failure
    raises :class:`~tpu_spmv_torch.bench.BenchFailure`), then timed under
    the physics guard: seconds a call."""
    check(spmv_matches(call().cpu().numpy(), A, x, rel_tol=rel_tol),
          f"{what} failed the oracle at rel {rel_tol}")
    return clock.guarded(call, stream_bytes, iters, what)


def device_main(parser, argv, run) -> int:
    """An A/B script's shell: ``parser`` gains ``--device`` (the card
    unless ``cpu``); ``run(clock, args)`` gives the rows, printed last as
    one JSON object with the device's name."""
    parser.add_argument("--device", default="cuda",
                        help="where to run: the card (default), or cpu")
    args = parser.parse_args(argv)
    clock = Clock.on(target_device(args.device, parser.prog))
    print(f"device: {clock.name}; STREAM {clock.stream_gbs} GB/s",
          flush=True)
    rows = run(clock, args)
    print(json.dumps({"device": clock.name, "rows": rows}), flush=True)
    return 0


def occupancy(host) -> float:
    """A host plan's occupancy; a banded stack's, its bands' weighted by
    their groups (as ``BandedPlan.occupancy``)."""
    plans = getattr(host, "plans", (host,))
    total = sum(p.n_groups for p in plans)
    return sum(p.occupancy * p.n_groups for p in plans) / total \
        if total else 0.0
