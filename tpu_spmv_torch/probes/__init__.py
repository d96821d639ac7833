"""The JAX package's benchmark probes on the card: each Pallas probe of
``benchmarks/`` as a hand-written CUDA kernel with a plain PyTorch version
beside it, and the script's ``main`` as ``python3 -m
tpu_spmv_torch.probes.<name>``.

* :mod:`.profile_kernel` (P4): K1's cost split by stage;
* :mod:`.proto_v3` (P2): the round-3 scatter candidates;
* :mod:`.proto_v4` (P3): the permutation scatter;
* :mod:`.profile_dma_share` (P5): re-reading a streamed block;
* :mod:`.proto_v2` (P1): the round-2 inner-loop candidates.

Each module makes the JAX main's inputs from the same seed
(``make_inputs``), runs its kernel (``probe``; the plain version,
``probe_plain``, for CPU tensors) and times the JAX main's modes
(``time_modes``).  Each ``probe`` counts its launches in ``probe.launches``;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets them
to 0.  The modules are imported when these are called, not here, so that
``python3 -m`` runs a module that the package has not imported yet.
"""

NAMES = ("profile_kernel", "proto_v3", "proto_v4", "profile_dma_share",
         "proto_v2")


def modules() -> dict:
    """``{name: module}`` of the five probes."""
    import importlib

    return {n: importlib.import_module(f"{__name__}.{n}") for n in NAMES}


def reset_launch_counts() -> None:
    for mod in modules().values():
        mod.probe.launches = 0


def launch_counts() -> dict:
    """``{probe name: launches}``."""
    return {n: mod.probe.launches for n, mod in modules().items()}
