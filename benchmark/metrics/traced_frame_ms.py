"""The traced frames' wall time, milliseconds a frame by the host's clock:
set beside the untraced frames' (the window's rate), it says how much the
profiler slowed the host, and so how much of `device_idle_pct` is the
profiler's cost and not the program's."""


def read(ctx, data):
    st = ctx['stretch']
    if not st.frames or not st.wall_s:
        return None
    return 1e3 * st.wall_s / st.frames
