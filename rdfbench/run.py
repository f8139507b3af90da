"""Run one cell of the benchmark from the root of a checkout:

    python3 rdfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The result is the last line of standard output (``harness.main``).
"""
import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel and compiler caches at fixed places inside the checkout, so
# that only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from rdfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
