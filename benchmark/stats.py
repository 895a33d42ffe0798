"""The benchmark's arithmetic: the window's rate and tail, the busy share
of a trace, and the roofline bound of a kernel's counted work. Frozen
here, with the operation counts, so that no change to the program moves
the yardstick."""

import statistics

# Peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# fp32 outside the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# fp32 operations of one piece of work, counted by hand in the port's CUDA
# sources (chip_smoke.py's OPS when the benchmark was written) and rounded
# down: a closest-hit Woop test against one cast primitive, an any-hit
# test, the rest of a path vertex (shading, emission and MIS, the light
# sample, two BSDF evaluations and a sample, roulette). The counts assume
# brute-force scans of the cast table.
OPS = dict(closest_test=45, any_test=55, vertex=420)

# Bytes of one film pixel (three float32 channels).
PIXEL_BYTES = 12


def window_rate(paths_per_frame, frame_ends, window_start):
    """Millions of camera paths a second: every frame that finished in the
    window, over the time from the window's start to the end of the last
    frame that finished."""
    if not frame_ends:
        return None
    return paths_per_frame * len(frame_ends) / \
        (frame_ends[-1] - window_start) / 1e6


def p95(values):
    """The 95th percentile of every value (Python's exclusive method)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[94]


def busy_seconds(intervals, lo=None, hi=None):
    """Length in seconds of the union of (start, end) intervals given in
    microseconds, each clipped to [lo, hi] where given."""
    busy, cur = 0.0, None
    for s, e in sorted(intervals):
        if lo is not None:
            s, e = max(s, lo), max(e, lo)
        if hi is not None:
            s, e = min(s, hi), min(e, hi)
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6


def bound_seconds(ops, nbytes):
    """The least seconds one H100 could take for `ops` fp32 operations and
    `nbytes` bytes moved."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def path_vertex_ops(vertices, cast_prims):
    """fp32 operations of `vertices` path vertices: a closest-hit scan of
    the cast table, one any-hit test (the least a shadow scan takes), the
    vertex's other work."""
    return vertices * (cast_prims * OPS['closest_test'] + OPS['any_test'] +
                       OPS['vertex'])

