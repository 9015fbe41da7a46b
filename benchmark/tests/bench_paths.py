"""Puts benchmark/ and the checkout's root on sys.path, as run.py does, so
that the benchmark's tests import the harness and the program. Each test
module imports it first:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
