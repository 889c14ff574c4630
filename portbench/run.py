"""The port's benchmark: one run of one cell on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared,
with its limit. Exits nonzero, printing no result, without a CUDA card.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import env  # noqa: E402

env.pin(ROOT)

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_process=T0))
