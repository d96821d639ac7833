"""The dispatch as the port's one seam for plans: which modules may import
what from where (read from the sources), and PageRank served by the plan
:func:`~tpu_spmv_torch.spmv.resolve_csr` resolves, its SCALAR_CSR retry
included.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv_torch  # noqa: E402
import tpu_spmv_torch.kernels.reorder as tr  # noqa: E402
import tpu_spmv_torch.spmv as tspmv  # noqa: E402
from tpu_spmv_torch import (DeviceCSR, KernelType,  # noqa: E402
                            PageRankConfig, SpMVConfig)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          transition_matrix, web_graph_csr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tpu_spmv_torch")
# what the dispatch and the kernels sit under
ABOVE = {"pagerank", "parallel", "benchmark", "bench", "benchmarks"}


def imports(path: str) -> list:
    """``(module, name)`` for every import in ``path``, at any depth (lazy
    imports too), relative ones resolved against the file's package;
    ``name`` is ``None`` for a plain ``import module``."""
    rel = os.path.relpath(path, ROOT)[:-len(".py")].split(os.sep)
    package = rel[:-1]
    found = []
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(alias.name, None) for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            module = ".".join(base + (node.module.split(".")
                                      if node.module else []))
            for alias in node.names:
                found.append((module, alias.name))
                if node.module is None:     # from . import submodule
                    found.append((f"{module}.{alias.name}", None))
    return found


def sources(*parts: str) -> list:
    top = os.path.join(PORT, *parts)
    if top.endswith(".py"):
        return [top]
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(top)
                  for f in fs if f.endswith(".py"))


def test_the_dispatch_and_the_kernels_import_nothing_above_them():
    bad = [(os.path.relpath(path, ROOT), module)
           for path in sources("spmv.py") + sources("kernels")
           for module, _ in imports(path)
           if module.split(".")[:1] == ["tpu_spmv_torch"]
           and module.split(".")[1:2] and module.split(".")[1] in ABOVE]
    assert not bad


def test_no_module_but_the_dispatch_imports_its_private_names():
    harness = [os.path.join(ROOT, f) for f in sorted(os.listdir(ROOT))
               if f.startswith("chip_") and f.endswith(".py")]
    bad = [(os.path.relpath(path, ROOT), name)
           for path in sources() + harness
           if not path.endswith(os.path.join("tpu_spmv_torch", "spmv.py"))
           for module, name in imports(path)
           if module == "tpu_spmv_torch.spmv" and name is not None
           and name.startswith("_")]
    assert not bad


@pytest.mark.parametrize("route", ["naive", "flat"])
@pytest.mark.parametrize("kernel_type", [KernelType.VECTOR_CSR,
                                         KernelType.MERGE_PATH])
def test_pagerank_serves_the_plan_resolve_csr_gives(monkeypatch, kernel_type,
                                                    route):
    """Where every packed layout rejects the matrix (pattern, single,
    banded, reordered and composite), PageRank runs on SCALAR_CSR's plan
    (the naive plan, or the flat path where that overflows too): the very
    plan ``resolve_csr`` gives for PageRank's configuration, and the ranks
    of the packed route."""
    A = transition_matrix(web_graph_csr(RandomGenerator(7), 3000, 3000,
                                        avg_nnz=8))
    cfg = PageRankConfig(max_iterations=20, tolerance=0.0,
                         kernel_type=kernel_type)
    packed = tpu_spmv_torch.pagerank(
        tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, A.values,
                                 A.col_indices, A.row_ptrs), cfg,
        device="cpu")

    def overflow(*a, **k):
        raise tplan.WindowEllOverflow("every packed layout rejects")

    for module, name in [(tspmv, "build_auto"), (tr, "build_auto"),
                         (tspmv, "build_composite")] \
            + [(tspmv, "build")] * (route == "flat"):
        monkeypatch.setattr(module, name, overflow)
    res = tpu_spmv_torch.pagerank(A, cfg, device="cpu")
    assert res.error_code == 0 == packed.error_code
    assert res.plan is tspmv.resolve_csr(A, kernel_type,
                                         SpMVConfig(pattern=True), "cpu")
    if route == "naive":
        assert isinstance(res.plan, twe.WindowEllPlan)
        assert res.plan.n_extra == 0
    else:
        assert isinstance(res.plan, DeviceCSR)
    assert isinstance(packed.plan, tspmv.PatternPlan)
    assert res.iterations == packed.iterations == 20
    np.testing.assert_allclose(res.ranks_host(), packed.ranks_host(),
                               rtol=1e-4, atol=1e-7)
