"""Build the host planner library: ``python -m tpu_spmv_torch.native.build``.

Compiles ``tpu_spmv_torch/native/native.cc``, the port's own copy of the
JAX package's ``tpu_spmv/native/native.cc`` (so both packages' planners run
the same balancing passes, and the port builds where the JAX package is
absent), with g++ and the flags of ``tpu_spmv/native/build.py`` into
``tpu_spmv_torch/_build/libtpu_spmv_native.so``.
"""

from __future__ import annotations

import os

from ..kernels._build import build_library

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native.cc")
LIB_NAME = "libtpu_spmv_native.so"


def build() -> str:
    cxx = os.environ.get("CXX", "g++")
    return build_library(LIB_NAME, [SRC], lambda out: [
        cxx, "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
        "-shared", "-fPIC", SRC, "-o", out])


if __name__ == "__main__":
    print(build())
