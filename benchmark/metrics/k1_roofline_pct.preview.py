"""k1_roofline_pct (metrics/k1_roofline_pct.py) in a preview cell, where
the frame's tail, not the rate of final frames, is what it moves."""

from benchmark.metrics.k1_roofline_pct import read  # noqa: F401
