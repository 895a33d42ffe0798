"""device_idle_pct (metrics/device_idle_pct.py) in a preview cell, where
the frame's tail, not the rate of final frames, is what it moves."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
