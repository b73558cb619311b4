"""Run one benchmark cell once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints progress and the compared numbers on standard error and, as the
last line of standard output, one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks`` last). Exits non-zero, with no result, without the card.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the program's kernel caches stay at fixed places inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
sys.path[0] = str(REPO)
sys.path.insert(1, str(REPO / "src"))

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
