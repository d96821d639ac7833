"""The window-ELL planner (:mod:`.plan`, NumPy), its device kernels
(:mod:`.window_ell`, CUDA through :mod:`._build`), and block reordering
(:mod:`.reorder`: the probe in NumPy, the chunk permute in CUDA).

Each kernel wrapper counts its launches in an integer attribute,
``launches``; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0."""

from .reorder import permute_chunks
from .window_ell import unpermute, window_ell_fold

_COUNTED = (window_ell_fold, unpermute, permute_chunks)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in _COUNTED}
