"""traced_frame_ms (metrics/traced_frame_ms.py) in a preview cell, where
the frame's tail, not the rate of final frames, is what it moves."""

from benchmark.metrics.traced_frame_ms import read  # noqa: F401
