"""Device milliseconds a frame of every device activity other than the
named kernels (K2): the per-bounce driver's torch operations around it
(hashing, camera rays, selects, the film's index_add_) and the film's
copy to the host."""


def read(ctx, data):
    st = ctx['stretch']
    rest = [e - s for n, s, e in st.device
            if not any(k in n for k in data['except'])]
    if not rest:
        return None
    return sum(rest) / 1e3 / st.frames
