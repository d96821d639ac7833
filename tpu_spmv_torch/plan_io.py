"""Plan files: save and load built plans (port of ``tpu_spmv/plan_io.py``).

A plan takes seconds to tens of seconds to build on the host and well
under a millisecond to run, so a process that saves it once skips the
planner from then on.  The format is the JAX package's, so a file moves
either way between the packages: one uncompressed ``.npz`` holding the
plan's array leaves under the JAX names and a JSON ``__meta__`` entry (the
kind, ``version`` = :data:`_VERSION`, each plan's static fields under
``<prefix>aux`` and its occupancy).  A bf16 value stream is stored as its
``uint16`` bits with a ``<prefix>vals_dtype = "bfloat16"`` tag (``npz``
cannot hold bf16); a file without ``tb`` (written before the field existed)
loads with the default run length.

Kinds: ``window_ell`` (f32, bf16 and pattern plans, natural or leveled),
``banded``, ``composite`` (its flat tail in the JAX ``DeviceCSR``'s padded
form), ``strips`` (each strip a plan or a banded stack, ``strip_kinds``) and
``reordered`` (a window-ELL or banded inner plan).  :func:`save_plan` takes a
device plan, or a host plan where the port keeps one (``HostPlan``,
``HostBanded``, ``HostComposite``, ``HostStrips``).  :func:`load_plan` makes
the device plan through :func:`~.kernels.window_ell.plan_from_arrays` and
:func:`~.kernels.reorder.reordered_from_arrays`, so the bounds are checked
and the fold schedule and tile maps are derived from the stored arrays as
on any upload: a loaded plan gives the saved plan's output bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .csr import CSRMatrix, DeviceCSR, _bucket
from .errors import (FileIOError, InvalidFormatError, guarded_upload,
                     target_device)
from .kernels.plan import (AUX, LEAVES, T_BASE, HostBanded, HostComposite,
                           HostPlan)
from .kernels.reorder import (ReorderedPlan, _check_maps,
                              reordered_from_arrays)
from .kernels.strips import HostStrips, StripPlan
from .kernels.window_ell import (BandedPlan, CompositePlan, WindowEllPlan,
                                 plan_from_arrays)

_VERSION = 1
# the JAX package's leaf and field names, in its order (lam is optional)
_WINDOW_LEAVES = LEAVES[:-1]
_WINDOW_AUX = AUX
_CSR_LEAVES = ("values", "col_indices", "row_ptrs", "row_ids")


def _array(a) -> tuple:
    """``(NumPy array, is bf16)`` of a tensor or array; a bf16 tensor as
    its uint16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).cpu().numpy().view(np.uint16), True
        return a.cpu().numpy(), False
    return np.asarray(a), False


def _py(v):
    """A static field as JSON takes it (NumPy scalars to Python)."""
    return v.item() if isinstance(v, np.generic) else v


def _window_entry(plan, prefix: str, arrays: dict, meta: dict) -> None:
    """A window-ELL plan's leaves and fields under ``prefix``."""
    leaves = {k: getattr(plan, k) for k in LEAVES}
    if isinstance(plan, HostPlan) and plan.values_dtype == "bfloat16":
        # the cast the upload makes (round to nearest even)
        leaves["vals"] = torch.from_numpy(plan.vals).to(torch.bfloat16)
    for name in _WINDOW_LEAVES:
        if leaves[name] is None:      # vals is absent on pattern plans
            continue
        a, bf16 = _array(leaves[name])
        if bf16:
            meta[prefix + name + "_dtype"] = "bfloat16"
        arrays[prefix + name] = a
    if leaves["lam"] is not None:
        arrays[prefix + "lam"] = _array(leaves["lam"])[0]
    meta[prefix + "aux"] = {k: _py(getattr(plan, k)) for k in _WINDOW_AUX}
    meta[prefix + "occupancy"] = float(plan.occupancy)


def _window_arrays(prefix: str, z, meta: dict) -> tuple:
    """``(leaves, aux, occupancy, values_dtype)`` of the plan under
    ``prefix``, as :func:`plan_from_arrays` takes them."""
    aux = dict(meta[prefix + "aux"])
    aux.setdefault("tb", T_BASE)      # a file from before the field
    leaves = {n: z[prefix + n] if prefix + n in z.files else None
              for n in LEAVES}
    vdt = "float32"
    if meta.get(prefix + "vals_dtype") == "bfloat16":
        vdt = "bfloat16"
        leaves["vals"] = np.asarray(leaves["vals"]).view(np.uint16)
    return leaves, aux, float(meta.get(prefix + "occupancy", 0.0)), vdt


def _window_from(prefix: str, z, meta: dict, device) -> WindowEllPlan:
    leaves, aux, occupancy, vdt = _window_arrays(prefix, z, meta)
    return plan_from_arrays(leaves, aux, device, occupancy, vdt)


def _banded_entry(bp, strip: str, arrays: dict, meta: dict) -> None:
    """A banded stack: its fields under ``<strip>_`` (a strip's, ``"s3"``)
    or no prefix (``strip=""``), band ``j`` under ``<strip>b<j>_``."""
    head = strip + "_" if strip else ""
    meta[head + "n_bands"] = len(bp.plans)
    meta[head + "band_rows"] = [int(r) for r in bp.band_rows]
    for j, q in enumerate(bp.plans):
        _window_entry(q, f"{strip}b{j}_", arrays, meta)


def _banded_from(strip: str, z, meta: dict, num_rows: int, num_cols: int,
                 device) -> BandedPlan:
    head = strip + "_" if strip else ""
    return BandedPlan(
        tuple(_window_from(f"{strip}b{j}_", z, meta, device)
              for j in range(meta[head + "n_bands"])),
        num_rows, num_cols, tuple(meta.get(head + "band_rows", ())))


def _tail_arrays(tail) -> dict:
    """A composite's flat tail (a device or host CSR) in the JAX
    ``DeviceCSR``'s padded form (``tpu_spmv/csr.py:305-330``): the nonzeros
    padded to their 1024-bucket with zeros at column 0, the row pointers to
    the rows' bucket with ``nnz``, and each padding nonzero's row the last
    padded row."""
    values, cols, ptr = (_array(getattr(tail, n))[0]
                         for n in _CSR_LEAVES[:3])
    nnz, rows = int(tail.nnz), tail.num_rows
    nnz_pad, rows_pad = _bucket(nnz), _bucket(rows)
    out = {"values": np.zeros(nnz_pad, np.float32),
           "col_indices": np.zeros(nnz_pad, np.int32),
           "row_ptrs": np.full(rows_pad + 1, nnz, np.int32),
           "row_ids": np.full(nnz_pad, rows_pad - 1, np.int32)}
    out["values"][:nnz] = values[:nnz]
    out["col_indices"][:nnz] = cols[:nnz]
    out["row_ptrs"][:rows + 1] = ptr[:rows + 1]
    out["row_ids"][:nnz] = np.repeat(np.arange(rows, dtype=np.int32),
                                     np.diff(ptr[:rows + 1]))
    return out


def save_plan(plan, path: str) -> None:
    """Write ``plan`` to ``path`` in the JAX package's format: a
    :class:`WindowEllPlan`, :class:`BandedPlan`, :class:`CompositePlan`,
    :class:`StripPlan` or :class:`ReorderedPlan` on any device, or a host
    ``HostPlan``, ``HostBanded``, ``HostComposite`` or ``HostStrips``.
    Raises :class:`InvalidFormatError` for any other type and
    :class:`FileIOError` where the file cannot be written."""
    arrays: dict = {}
    meta: dict = {"version": _VERSION}
    if isinstance(plan, (StripPlan, HostStrips)):
        meta.update(kind="strips", n_strips=len(plan.plans),
                    num_rows=plan.num_rows, num_cols=plan.num_cols,
                    bounds=[[int(v) for v in b] for b in plan.bounds])
        kinds = []
        for i, p in enumerate(plan.plans):
            if isinstance(p, (BandedPlan, HostBanded)):
                kinds.append("banded")
                meta[f"s{i}_shape"] = [p.num_rows, p.num_cols]
                _banded_entry(p, f"s{i}", arrays, meta)
            else:
                kinds.append("window_ell")
                _window_entry(p, f"s{i}_", arrays, meta)
        meta["strip_kinds"] = kinds
    elif isinstance(plan, (WindowEllPlan, HostPlan)):
        meta["kind"] = "window_ell"
        _window_entry(plan, "p_", arrays, meta)
    elif isinstance(plan, (BandedPlan, HostBanded)):
        meta.update(kind="banded", num_rows=plan.num_rows,
                    num_cols=plan.num_cols)
        _banded_entry(plan, "", arrays, meta)
    elif isinstance(plan, (CompositePlan, HostComposite)):
        meta.update(kind="composite", n_levels=len(plan.plans),
                    num_rows=plan.num_rows, num_cols=plan.num_cols)
        for i, p in enumerate(plan.plans):
            _window_entry(p, f"l{i}_", arrays, meta)
        if plan.tail is not None:
            meta["tail"] = {"num_rows": plan.tail.num_rows,
                            "num_cols": plan.tail.num_cols,
                            "nnz": int(plan.tail.nnz)}
            for name, a in _tail_arrays(plan.tail).items():
                arrays["t_" + name] = a
    elif isinstance(plan, ReorderedPlan):
        meta.update(kind="reordered", num_rows=plan.num_rows,
                    num_cols=plan.num_cols)
        arrays["r_col_src"] = _array(plan.col_src)[0]
        arrays["r_row_src"] = _array(plan.row_src)[0]
        if isinstance(plan.inner, BandedPlan):
            meta["inner_kind"] = "banded"
            meta["inner_shape"] = [plan.inner.num_rows, plan.inner.num_cols]
            _banded_entry(plan.inner, "", arrays, meta)
        else:
            meta["inner_kind"] = "window_ell"
            _window_entry(plan.inner, "p_", arrays, meta)
    else:
        raise InvalidFormatError(
            f"save_plan: unsupported plan type {type(plan).__name__}")
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    try:
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    except OSError as e:
        raise FileIOError(str(e)) from e


def load_plan(path: str, device=None):
    """Load a plan that :func:`save_plan` (of either package) wrote, onto
    ``device``: the card unless the caller names another.  Raises
    :class:`FileIOError` where the file cannot be read,
    :class:`InvalidFormatError` where it is not a plan file, is of a newer
    format version or holds a malformed plan, and
    :class:`~tpu_spmv_torch.errors.DeviceAllocError` with no CUDA device
    and none named."""
    device = target_device(device, "load_plan")
    try:
        ctx = np.load(path, allow_pickle=False)
    except OSError as e:
        raise FileIOError(str(e)) from e
    except Exception as e:  # not an npz (ValueError, BadZipFile, ...)
        raise InvalidFormatError(f"{path}: not a tpu_spmv plan file "
                                 f"({e})") from e
    with ctx as z:
        if "__meta__" not in z.files:
            raise InvalidFormatError(f"{path}: not a tpu_spmv plan file")
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta.get("version", 0) > _VERSION:
            raise InvalidFormatError(
                f"{path}: plan format v{meta['version']} is newer than "
                f"this library (v{_VERSION})")
        try:
            return _load(z, meta, device)
        except KeyError as e:
            raise InvalidFormatError(f"{path}: plan file lacks {e}") from e


def _load(z, meta: dict, device):
    kind = meta.get("kind")
    if kind == "window_ell":
        return _window_from("p_", z, meta, device)
    if kind == "banded":
        return _banded_from("", z, meta, meta["num_rows"], meta["num_cols"],
                            device)
    if kind == "strips":
        plans = []
        for i, k in enumerate(meta["strip_kinds"]):
            if k == "banded":
                nr, nc = meta[f"s{i}_shape"]
                plans.append(_banded_from(f"s{i}", z, meta, nr, nc, device))
            else:
                plans.append(_window_from(f"s{i}_", z, meta, device))
        return StripPlan(tuple(plans), meta["num_rows"], meta["num_cols"],
                         tuple(tuple(b) for b in meta["bounds"]))
    if kind == "reordered":
        col_src, row_src = z["r_col_src"], z["r_row_src"]
        nr, nc = meta["num_rows"], meta["num_cols"]
        if meta["inner_kind"] != "banded":
            leaves, aux, occupancy, vdt = _window_arrays("p_", z, meta)
            return reordered_from_arrays(leaves, aux, col_src, row_src, nr,
                                         nc, device, occupancy, vdt)
        inr, inc = meta["inner_shape"]
        col_src = np.ascontiguousarray(col_src, np.int32)
        row_src = np.ascontiguousarray(row_src, np.int32)
        _check_maps(col_src, row_src, nr, nc, inr, inc)
        return ReorderedPlan(_banded_from("", z, meta, inr, inc, device),
                             guarded_upload(col_src, device),
                             guarded_upload(row_src, device), nr, nc)
    if kind == "composite":
        plans = tuple(_window_from(f"l{i}_", z, meta, device)
                      for i in range(meta["n_levels"]))
        tail = None
        if "tail" in meta:
            t = meta["tail"]
            nnz, rows = t["nnz"], t["num_rows"]
            tail = DeviceCSR.from_host(CSRMatrix(
                rows, t["num_cols"], z["t_values"][:nnz],
                z["t_col_indices"][:nnz], z["t_row_ptrs"][:rows + 1]),
                device)
        return CompositePlan(plans, tail, meta["num_rows"],
                             meta["num_cols"])
    raise InvalidFormatError(f"unknown plan kind {kind!r}")


def load_as(cls, path: str, device=None):
    """:func:`load_plan`, raising :class:`InvalidFormatError` unless the
    file holds a ``cls`` (the plans' ``load`` methods)."""
    plan = load_plan(path, device)
    if not isinstance(plan, cls):
        raise InvalidFormatError(
            f"{path}: holds a {type(plan).__name__}, not a {cls.__name__}")
    return plan
