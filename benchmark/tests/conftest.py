"""The benchmark's CPU tests: python -m pytest benchmark/tests -q (from
the repository's root). None needs a GPU; the cells' runs on one are the
benchmark itself."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
