"""python3 -m aecm_bench: one run of one cell (see harness.py)."""
import time

_T_PROC0 = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402

from aecm_bench.harness import main  # noqa: E402

sys.exit(main(t_proc0=_T_PROC0))
