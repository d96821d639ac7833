"""``setup_s``: process start to the first timed call (imports, CUDA
context, kernel library load, matrix and vectors from the seed, plan build
and upload, warm-up)."""


def read(run):
    return run.setup_s
