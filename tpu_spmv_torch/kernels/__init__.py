"""The window-ELL planner (:mod:`.plan`, NumPy), its device kernels
(:mod:`.window_ell`, CUDA through :mod:`._build`: the gather table's
set-up, which is the chunk permute, the fold and the epilogues) and the
banded and composite stacks of plans, column strips (:mod:`.strips`), block
reordering (:mod:`.reorder`: the probe in NumPy, the reordered plan), and
the flat path (:mod:`.scalar`, plain PyTorch ops).

Each kernel counts its launches in an attribute of a wrapper, ``launches``
(for K1's fold a dict per value stream); :func:`launch_counts` reads them
all and :func:`reset_launch_counts` sets them to 0."""

from .reorder import ReorderedPlan, build_reordered, spmv_reordered
from .scalar import spmv_csr_scalar
from .strips import StripPlan, build_strips, spmv_strips
from .window_ell import (FOLD_VARIANTS, BandedPlan, CompositePlan,
                         WindowEllPlan, permute_chunks, section_epilogue,
                         spmv_banded, spmv_composite, spmv_pattern_banded,
                         spmv_window_ell, unpermute, window_ell_fold)

__all__ = [
    "WindowEllPlan", "spmv_window_ell", "BandedPlan", "spmv_banded",
    "spmv_pattern_banded", "CompositePlan", "spmv_composite", "StripPlan",
    "build_strips", "spmv_strips", "ReorderedPlan", "build_reordered",
    "spmv_reordered", "spmv_csr_scalar", "FOLD_VARIANTS", "permute_chunks",
    "section_epilogue", "unpermute", "window_ell_fold", "launch_counts",
    "reset_launch_counts",
]


def reset_launch_counts() -> None:
    for fn in (section_epilogue, unpermute, permute_chunks):
        fn.launches = 0
    window_ell_fold.launches = dict.fromkeys(FOLD_VARIANTS, 0)


def launch_counts() -> dict:
    """``{kernel name: launches}``: K1's fold once per variant (f32, bf16
    and pattern value streams) and its section epilogue (one launch after
    each section but the last of an SpMV), then K2 (the SpMV's final
    epilogue) and K3 (the gather table's set-up, once a call, and the
    public ``permute_chunks``)."""
    counts = {name: window_ell_fold.launches[v]
              for v, name in FOLD_VARIANTS.items()}
    counts.update(section_epilogue=section_epilogue.launches,
                  unpermute=unpermute.launches,
                  permute_chunks=permute_chunks.launches)
    return counts
