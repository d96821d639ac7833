"""``python3 -m spmvbench``: one run of one cell (see :mod:`spmvbench.run`)."""

import time

# set-up is timed from here, before any heavy import
START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from spmvbench.run import main

    sys.exit(main(sys.argv[1:], start=START))
