"""K1's bound over its device time a frame. The bound is the larger of
its fp32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s: the
path vertices a frame, from the reference's count on the compared pixels
scaled to the frame, each a closest-hit scan of the cast table, one
any-hit test and the vertex's other work; the scene tables read once and
the film written once."""

from benchmark import stats
from benchmark.metrics import per_frame_kernel_seconds, table_bytes


def read(ctx, data):
    secs = per_frame_kernel_seconds(ctx, data)
    if secs is None or 'vertices' not in ctx['work']:
        return None
    n = ctx['width'] * ctx['height']
    vertices = ctx['work']['vertices'] * n * ctx['spp']
    ops = stats.path_vertex_ops(vertices, ctx['ref'].cast_prims)
    nbytes = table_bytes(ctx['ref']) + stats.PIXEL_BYTES * n
    return 100.0 * stats.bound_seconds(ops, nbytes) / secs
