"""The share of the traced stretch in which no kernel, copy or set runs on
the device: one minus the union of the device's intervals over the
stretch's wall time."""


def read(ctx, data):
    st = ctx['stretch']
    if not st.device or not st.wall_s:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.wall_s)
