"""The device's idle time while the host is inside render(), milliseconds
a traced frame: the traced stretch's time in which no device activity runs
and some span of the program's render() is open (benchmark/spans.py names
each part by the innermost span; this sums them), over the stretch's
frames. The rest of the stretch's idle time is the harness's own, between
frames."""

from benchmark import spans


def read(ctx, data):
    st = ctx['stretch']
    if not st.device or not st.frames or not ctx['traced_frames']:
        return None
    idle = spans.idle_by_span(ctx['spans'], st.device_ns(), st.lo_ns,
                              st.hi_ns)
    inside = sum(v for k, v in idle.items() if k != spans.OUTSIDE)
    return inside / 1e6 / st.frames
