"""ctypes bindings for the host planner library (port of
``tpu_spmv/native/__init__.py``, the entry points the planner uses).

The library is compiled from the port's copy of the JAX package's
``native.cc`` (``tpu_spmv_torch/native/native.cc``) on first use
(:mod:`.build`), never at import.  Every entry point keeps the JAX package's
NumPy fallback, taken when the library cannot be built or
``TPU_SPMV_NO_NATIVE`` is set; the balancing passes then return ``None`` and
plans come out correct but unbalanced.  Paths that need representative plans
call :func:`require`, which turns a missing library into an error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys

import numpy as np

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)
_P8 = ctypes.POINTER(ctypes.c_int8)
_I64 = ctypes.c_int64

_SIGNATURES = {
    "cumcount_i64": ([_P64, _I64, _P64], None),
    "cumcount_bounded_i64": ([_P64, _I64, _I64, _P64], None),
    "plan_derive_bounded_i64": (
        [_P64, _P64, _P64, _I64, _I64, _I64, _I64, _P64, _P64, _P64], None),
    "plan_derive_i64": ([_P64, _P64, _P64, _I64, _I64, _I64, _P64, _P64,
                         _P64], None),
    "unique_ic_bounded_i64": ([_P64, _I64, _I64, _P64, _P64, _P64], _I64),
    "unique_inverse_counts_i64": ([_P64, _I64, _P64, _P64, _P64], _I64),
    "plan_positions_i64": ([_P32, _I64, _P64, _P64, _I64, _P64, _P64], None),
    "fill_slots_f32": ([_I64, _P64, _PF, _P64, _P64, _PF, _P8, _P8], None),
    "spmv_cpu_csr_f32": ([ctypes.c_int32, _P32, _P32, _PF, _PF, _PF], None),
    "balance_extra_lanes_i64": ([_I64, _P64, _P64, _I64, _I64, _I64, _P64],
                                None),
    "balance_extra_slots2_i64": ([_I64, _P64, _P64, _I64, _P64, _I64, _I64,
                                  _I64, _I64, _P64], None),
    "balance_row_tiles_i64": ([_I64, _P64, _P64, _P64, _I64, _I64, _P64],
                              None),
    "coo_to_csr_f32": ([ctypes.c_int32, _I64, _P32, _P32, _PF, _P32, _P32,
                        _PF], None),
    "mtx_open": ([ctypes.c_char_p, _P32, _P32, _P64, _P32],
                 ctypes.c_void_p),
    "mtx_fetch": ([ctypes.c_void_p, _P32, _P32, _PF], None),
    "mtx_close": ([ctypes.c_void_p], None),
}


def _load() -> ctypes.CDLL:
    from .build import build

    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def _library():
    """The loaded library, or ``None`` (disabled, or the build failed —
    reported once on stderr, as the JAX package does)."""
    if os.environ.get("TPU_SPMV_NO_NATIVE"):
        return None
    try:
        return _load()
    except (OSError, RuntimeError, AttributeError) as e:
        print(
            "WARNING [tpu_spmv_torch.native]: building or loading the "
            f"planner library failed ({type(e).__name__}: {e}). The "
            "planner's balancing passes degrade to unbalanced plans. Run "
            "`python -m tpu_spmv_torch.native.build` to see the error.",
            file=sys.stderr, flush=True)
        return None


def available() -> bool:
    """Whether the library is loaded (building it on the first call);
    false where ``TPU_SPMV_NO_NATIVE`` is set, as :func:`require` sees it."""
    return not os.environ.get("TPU_SPMV_NO_NATIVE") and _library() is not None


def require() -> None:
    """Raise unless the library is loaded (the main path calls this so a
    failed build cannot silently degrade plans to unbalanced ones)."""
    if os.environ.get("TPU_SPMV_NO_NATIVE"):
        raise RuntimeError(
            "tpu_spmv_torch.native required but disabled via "
            "TPU_SPMV_NO_NATIVE")
    if _library() is None:
        # build again to surface the compiler's own message
        _load()


_warned: set = set()


def _warn_noop(name: str) -> None:
    if os.environ.get("TPU_SPMV_NO_BALANCE") or name in _warned:
        return
    _warned.add(name)
    print(
        f"WARNING [tpu_spmv_torch.native]: {name} skipped — native library "
        "not loaded; plans will be UNBALANCED.",
        file=sys.stderr, flush=True)


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# direct-addressed counters while the key space fits ~200 MB of host
# working set; hash passes above it (same bound as the JAX package)
_DIRECT_KEYS_MAX = 1 << 24
# depth-counter budget for the lane balancers; hashed tables above it
_BALANCE_MAX_CELLS = 1 << 25


def cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its key group."""
    keys = np.ascontiguousarray(keys, np.int64)
    n = len(keys)
    lib = _library()
    if lib is not None and n:
        out = np.empty(n, np.int64)
        kmax = int(keys.max())
        if 0 <= int(keys.min()) and kmax < _DIRECT_KEYS_MAX:
            lib.cumcount_bounded_i64(_p(keys, ctypes.c_int64), n, kmax + 1,
                                     _p(out, ctypes.c_int64))
        else:
            lib.cumcount_i64(_p(keys, ctypes.c_int64), n,
                             _p(out, ctypes.c_int64))
        return out
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    counts = np.diff(np.r_[starts, n])
    out = np.empty(n, np.int64)
    out[order] = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    return out


def spmv_cpu_csr_native(num_rows: int, row_ptrs: np.ndarray,
                        col_indices: np.ndarray, values: np.ndarray,
                        x: np.ndarray, y: np.ndarray) -> bool:
    """Native golden oracle; returns False if the library is absent."""
    lib = _library()
    if lib is None:
        return False
    lib.spmv_cpu_csr_f32(
        num_rows,
        _p(np.ascontiguousarray(row_ptrs, np.int32), ctypes.c_int32),
        _p(np.ascontiguousarray(col_indices, np.int32), ctypes.c_int32),
        _p(np.ascontiguousarray(values, np.float32), ctypes.c_float),
        _p(np.ascontiguousarray(x, np.float32), ctypes.c_float),
        _p(y, ctypes.c_float))
    return True


def coo_to_csr(num_rows: int, coo_rows: np.ndarray, coo_cols: np.ndarray,
               coo_vals: np.ndarray):
    """Stable COO→CSR (a counting sort by row); returns ``(row_ptrs,
    col_indices, values)``."""
    nnz = len(coo_rows)
    row_ptrs = np.zeros(num_rows + 1, np.int32)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, np.float32)
    lib = _library()
    if lib is not None:
        lib.coo_to_csr_f32(
            num_rows, nnz,
            _p(np.ascontiguousarray(coo_rows, np.int32), ctypes.c_int32),
            _p(np.ascontiguousarray(coo_cols, np.int32), ctypes.c_int32),
            _p(np.ascontiguousarray(coo_vals, np.float32), ctypes.c_float),
            _p(row_ptrs, ctypes.c_int32), _p(out_cols, ctypes.c_int32),
            _p(out_vals, ctypes.c_float))
        return row_ptrs, out_cols, out_vals
    order = np.argsort(np.asarray(coo_rows, np.int64), kind="stable")
    rr = np.asarray(coo_rows, np.int64)[order]
    out_cols[:] = np.asarray(coo_cols, np.int32)[order]
    out_vals[:] = np.asarray(coo_vals, np.float32)[order]
    row_ptrs[1:] = np.cumsum(np.bincount(rr, minlength=num_rows))
    return row_ptrs, out_cols, out_vals


def mtx_read(path: str):
    """Matrix Market file → ``(num_rows, num_cols, coo_rows, coo_cols,
    coo_vals)``: the native parser when the library is loaded, else a
    Python one.  Raises :class:`~tpu_spmv_torch.errors.FileIOError` for a
    file that cannot be read,
    :class:`~tpu_spmv_torch.errors.InvalidFormatError` for one that is not a
    coordinate Matrix Market file."""
    lib = _library()
    if lib is None:
        return _mtx_read_py(path)
    from ..errors import FileIOError, InvalidFormatError

    nr, nc = ctypes.c_int32(), ctypes.c_int32()
    nnz, err = ctypes.c_int64(), ctypes.c_int32()
    handle = lib.mtx_open(os.fsencode(path), ctypes.byref(nr),
                          ctypes.byref(nc), ctypes.byref(nnz),
                          ctypes.byref(err))
    if not handle:
        raise (InvalidFormatError if err.value == -5 else FileIOError)(
            f"mtx_read({path}): error {err.value}")
    rows = np.empty(nnz.value, np.int32)
    cols = np.empty(nnz.value, np.int32)
    vals = np.empty(nnz.value, np.float32)
    try:
        lib.mtx_fetch(handle, _p(rows, ctypes.c_int32),
                      _p(cols, ctypes.c_int32), _p(vals, ctypes.c_float))
    finally:
        lib.mtx_close(handle)
    return int(nr.value), int(nc.value), rows, cols, vals


def _mtx_read_py(path: str):
    from ..errors import FileIOError, InvalidFormatError

    try:
        f = open(path, "r")
    except OSError as e:
        raise FileIOError(str(e)) from e
    with f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise InvalidFormatError("not a MatrixMarket file")
        if "coordinate" not in header or "complex" in header:
            raise InvalidFormatError("unsupported MatrixMarket variant")
        pattern = "pattern" in header
        symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nr, nc, n = (int(v) for v in line.split()[:3])
        rows, cols, vals = [], [], []
        for _ in range(n):
            parts = f.readline().split()
            r, c = int(parts[0]) - 1, int(parts[1]) - 1
            v = 1.0 if pattern else float(parts[2])
            rows.append(r)
            cols.append(c)
            vals.append(v)
            if symmetric and r != c:
                rows.append(c)
                cols.append(r)
                vals.append(v)
        return nr, nc, np.asarray(rows, np.int32), \
            np.asarray(cols, np.int32), np.asarray(vals, np.float32)


def balance_extra_lanes(ext_ptr: np.ndarray, ext_wc: np.ndarray,
                        n_wc: int, sup_rows: int = 1024):
    """Exhaustive-greedy lane assignment for extras blocks; the per-extra
    lane array, or ``None`` without the library (or with
    ``TPU_SPMV_NO_BALANCE``)."""
    n_extra = len(ext_ptr) - 1
    lib = _library()
    if lib is None or n_extra <= 0 \
            or os.environ.get("TPU_SPMV_NO_BALANCE"):
        if lib is None and n_extra > 0:
            _warn_noop("balance_extra_lanes")
        return None
    blocks_per_sup = max(sup_rows // 128, 1)
    n_sups = -(-n_extra // (blocks_per_sup * 128))
    hash_bits = 0 if n_sups * n_wc * 128 <= _BALANCE_MAX_CELLS else 18
    out = np.empty(n_extra, np.int64)
    lib.balance_extra_lanes_i64(
        n_extra,
        _p(np.ascontiguousarray(ext_ptr, np.int64), ctypes.c_int64),
        _p(np.ascontiguousarray(ext_wc, np.int64), ctypes.c_int64),
        n_wc, blocks_per_sup, hash_bits, _p(out, ctypes.c_int64))
    return out


def balance_extra_slots(ext_ptr: np.ndarray, ext_wc: np.ndarray,
                        n_wc: int, sup_rows: int = 1024,
                        window_sups: int = 2, ext_crow=None,
                        layer_aware: int | None = None):
    """Sliding-window (superblock, lane) slot assignment for extras; the
    per-extra new index (a permutation of ``arange(n_extra)``), or ``None``
    without the library (or with ``TPU_SPMV_NO_BALANCE``).  ``layer_aware``
    defaults to env ``TPU_SPMV_BALANCE_LAYER`` (2 = atom-aware layer
    cost)."""
    n_extra = len(ext_ptr) - 1
    lib = _library()
    if lib is None or n_extra <= 0 \
            or os.environ.get("TPU_SPMV_NO_BALANCE"):
        if lib is None and n_extra > 0:
            _warn_noop("balance_extra_slots")
        return None
    if layer_aware is None:
        layer_aware = int(os.environ.get("TPU_SPMV_BALANCE_LAYER", "2"))
    n_sups = -(-n_extra // sup_rows)
    hash_bits = 0 if n_sups * n_wc * 128 <= _BALANCE_MAX_CELLS else 18
    out = np.empty(n_extra, np.int64)
    crow_arr = np.ascontiguousarray(ext_crow, np.int64) \
        if ext_crow is not None else None  # keep alive across the call
    crow_p = _p(crow_arr, ctypes.c_int64) if crow_arr is not None else None
    lib.balance_extra_slots2_i64(
        n_extra,
        _p(np.ascontiguousarray(ext_ptr, np.int64), ctypes.c_int64),
        _p(np.ascontiguousarray(ext_wc, np.int64), ctypes.c_int64),
        n_wc, crow_p, sup_rows, window_sups, hash_bits,
        int(layer_aware), _p(out, ctypes.c_int64))
    return out


def balance_row_tiles(row_ptrs: np.ndarray, wc: np.ndarray, n_wc: int,
                      sup_rows: int, parts: np.ndarray | None = None):
    """Within-superblock row→lane leveling; the per-row lane array, or
    ``None`` without the library (or with ``TPU_SPMV_NO_BALANCE``), in which
    case callers keep the natural order."""
    n_rows = len(row_ptrs) - 1
    lib = _library()
    if lib is None or n_rows <= 0 \
            or os.environ.get("TPU_SPMV_NO_BALANCE"):
        if lib is None and n_rows > 0:
            _warn_noop("balance_row_tiles")
        return None
    out = np.empty(n_rows, np.int64)
    parts_arr = np.ascontiguousarray(parts, np.int64) \
        if parts is not None else None  # keep alive across the call
    parts_p = _p(parts_arr, ctypes.c_int64) if parts_arr is not None \
        else None
    rp = np.ascontiguousarray(row_ptrs, np.int64)
    wc_arr = np.ascontiguousarray(wc, np.int64)
    lib.balance_row_tiles_i64(
        n_rows, _p(rp, ctypes.c_int64), _p(wc_arr, ctypes.c_int64),
        parts_p, n_wc, sup_rows, _p(out, ctypes.c_int64))
    return out


def plan_positions(row_ptrs: np.ndarray, parts: np.ndarray,
                   extra_base_of_row: np.ndarray, extras_base: int):
    """Per-nnz (pos, row_of) for the strided row-split assignment."""
    rows = len(parts)
    row_ptrs = np.ascontiguousarray(row_ptrs, np.int32)
    nnz = int(row_ptrs[-1]) if rows else 0
    lib = _library()
    if lib is not None and nnz:
        pos = np.empty(nnz, np.int64)
        row_of = np.empty(nnz, np.int64)
        parts_arr = np.ascontiguousarray(parts, np.int64)
        ebr = np.ascontiguousarray(extra_base_of_row, np.int64)
        lib.plan_positions_i64(
            _p(row_ptrs, ctypes.c_int32), rows,
            _p(parts_arr, ctypes.c_int64), _p(ebr, ctypes.c_int64),
            extras_base, _p(pos, ctypes.c_int64),
            _p(row_of, ctypes.c_int64))
        return pos, row_of
    row_len = np.diff(row_ptrs).astype(np.int64)
    row_of = np.repeat(np.arange(rows, dtype=np.int64), row_len)
    in_row = np.arange(nnz, dtype=np.int64) - \
        np.repeat(row_ptrs[:-1].astype(np.int64), row_len)
    part = in_row % np.repeat(np.maximum(parts, 1), row_len)
    pos = np.where(part == 0, row_of,
                   extras_base + np.repeat(extra_base_of_row, row_len)
                   + part - 1)
    return pos, row_of


def plan_derive(pos: np.ndarray, w: np.ndarray, c: np.ndarray,
                n_windows: int, sup_rows: int):
    """Fused lane/superblock decode + per-cell layer cumcount; returns
    (lane, sup, layer) int64 arrays."""
    pos = np.ascontiguousarray(pos, np.int64)
    w = np.ascontiguousarray(w, np.int64)
    c = np.ascontiguousarray(c, np.int64)
    n = len(pos)
    lib = _library()
    if lib is not None and n:
        lane = np.empty(n, np.int64)
        sup = np.empty(n, np.int64)
        layer = np.empty(n, np.int64)
        key_space = ((int(pos.max()) // sup_rows + 1) * n_windows) * 1024
        if key_space < _DIRECT_KEYS_MAX and int(pos.min()) >= 0:
            lib.plan_derive_bounded_i64(
                _p(pos, ctypes.c_int64), _p(w, ctypes.c_int64),
                _p(c, ctypes.c_int64), n, n_windows, sup_rows, key_space,
                _p(lane, ctypes.c_int64), _p(sup, ctypes.c_int64),
                _p(layer, ctypes.c_int64))
        else:
            lib.plan_derive_i64(
                _p(pos, ctypes.c_int64), _p(w, ctypes.c_int64),
                _p(c, ctypes.c_int64), n, n_windows, sup_rows,
                _p(lane, ctypes.c_int64), _p(sup, ctypes.c_int64),
                _p(layer, ctypes.c_int64))
        return lane, sup, layer
    lane = pos % 128
    sup = pos // sup_rows
    cell = ((sup * n_windows + w) * 8 + c) * 128 + lane
    return lane, sup, cumcount(cell)


def unique_inverse_counts(keys: np.ndarray):
    """``np.unique(keys, return_inverse=True, return_counts=True)`` via one
    hash pass (native) or NumPy."""
    keys = np.ascontiguousarray(keys, np.int64)
    n = len(keys)
    lib = _library()
    if lib is not None and n:
        uniq = np.empty(n, np.int64)
        inv = np.empty(n, np.int64)
        counts = np.empty(n, np.int64)
        kmax = int(keys.max())
        if 0 <= int(keys.min()) and kmax < _DIRECT_KEYS_MAX:
            m = lib.unique_ic_bounded_i64(
                _p(keys, ctypes.c_int64), n, kmax + 1,
                _p(uniq, ctypes.c_int64), _p(inv, ctypes.c_int64),
                _p(counts, ctypes.c_int64))
        else:
            m = lib.unique_inverse_counts_i64(
                _p(keys, ctypes.c_int64), n, _p(uniq, ctypes.c_int64),
                _p(inv, ctypes.c_int64), _p(counts, ctypes.c_int64))
        return uniq[:m].copy(), inv, counts[:m].copy()
    return np.unique(keys, return_inverse=True, return_counts=True)


def fill_slots(flat: np.ndarray, values: np.ndarray, cols_mod: np.ndarray,
               sbv: np.ndarray, vals_out: np.ndarray, lo_out: np.ndarray,
               sb_out: np.ndarray) -> None:
    """Scatter per-nnz (value, lane index, sub-block) into the packed slot
    arrays in one pass."""
    n = len(flat)
    lib = _library()
    if lib is not None and n:
        flat = np.ascontiguousarray(flat, np.int64)
        values = np.ascontiguousarray(values, np.float32)
        cols_mod = np.ascontiguousarray(cols_mod, np.int64)
        sbv = np.ascontiguousarray(sbv, np.int64)
        lib.fill_slots_f32(
            n, _p(flat, ctypes.c_int64), _p(values, ctypes.c_float),
            _p(cols_mod, ctypes.c_int64), _p(sbv, ctypes.c_int64),
            _p(vals_out.reshape(-1), ctypes.c_float),
            _p(lo_out.reshape(-1), ctypes.c_int8),
            _p(sb_out.reshape(-1), ctypes.c_int8))
        return
    vals_out.reshape(-1)[flat] = values
    lo_out.reshape(-1)[flat] = cols_mod.astype(np.int8)
    sb_out.reshape(-1)[flat] = sbv.astype(np.int8)
