"""K2's device milliseconds a frame, from the trace."""

from benchmark.metrics import per_frame_kernel_seconds


def read(ctx, data):
    secs = per_frame_kernel_seconds(ctx, data)
    return None if secs is None else 1e3 * secs
