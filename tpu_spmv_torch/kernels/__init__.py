"""The window-ELL planner (:mod:`.plan`, NumPy), its device kernels
(:mod:`.window_ell`, CUDA through :mod:`._build`), and block reordering
(:mod:`.reorder`: the probe in NumPy, the chunk permute in CUDA).

Each kernel wrapper counts its launches in an attribute, ``launches`` (for
K1's fold a dict per value stream); :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0."""

from .reorder import permute_chunks
from .window_ell import (FOLD_VARIANTS, chunk_reduce, unpermute,
                         window_ell_fold)


def reset_launch_counts() -> None:
    for fn in (chunk_reduce, unpermute, permute_chunks):
        fn.launches = 0
    window_ell_fold.launches = dict.fromkeys(FOLD_VARIANTS, 0)


def launch_counts() -> dict:
    """``{kernel name: launches}``: K1's fold once per variant (f32, bf16
    and pattern value streams) and its ordered reduce (one launch per
    section that split a superblock), then K2 and K3."""
    counts = {name: window_ell_fold.launches[v]
              for v, name in FOLD_VARIANTS.items()}
    counts.update(chunk_reduce=chunk_reduce.launches,
                  unpermute=unpermute.launches,
                  permute_chunks=permute_chunks.launches)
    return counts
