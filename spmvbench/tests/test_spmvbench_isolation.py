"""What the benchmark imports, and a run without a card."""

import os
import subprocess
import sys

from conftest import REPO

ALL = """
import glob, os, sys
sys.path.insert(0, {repo!r})
import spmvbench.run as h, spmvbench.trace
for kind in ("generators", "loops", "metrics"):
    for p in sorted(glob.glob(os.path.join({repo!r}, "spmvbench", kind, "*.py"))):
        if not p.endswith("__init__.py"):
            h.load_module(p, kind + os.path.basename(p))
import tpu_spmv_torch
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {repo!r})
import spmvbench.reference.plain, spmvbench.reference.models
import spmvbench.reference.matrix
import spmvbench.generators.power_law, spmvbench.generators.graph500
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(repo=REPO)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    names = top_level_names(ALL)
    assert "tpu_spmv_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "tpu_spmv"}, names


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "tpu_spmv",
                        "tpu_spmv_torch"}, names


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from spmvbench import run

    monkeypatch.setitem(sys.modules, "tpu_spmv_torch_fake", object())
    assert "tpu_spmv" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_spmv.kernels", object())
    assert "tpu_spmv" in run.forbidden_modules()


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "spmvbench", "--workload",
         "powerlaw262k.solve", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA device" in out.stderr


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    import shutil

    shutil.copytree(os.path.join(REPO, "spmvbench"),
                    tmp_path / "spmvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "spmvbench", "--workload",
         "powerlaw262k.solve", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
