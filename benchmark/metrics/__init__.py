"""Per-layer metric readers: metrics/<name>.py holds read(ctx, data), and
metrics/<name>.json the data it reads by (the kernels it times). A reader
returns None where the trace holds nothing to read, never 0.

ctx, from a `--trace 1` run (benchmark/harness.py): 'stretch' (the traced
frames: a benchmark.spans.SpanStretch, the device's activities also on
the spans' clock, with the program's launch counters over them,
kernels.LAUNCHES, in its `launches`), 'work' (the reference's
work a path on the compared pixels, as its kind's film_pixels counts it),
'ref' (the reference scene its kind built), 'width', 'height', 'spp',
'spans' (the program's spans over the whole window, its recorder on:
tuples read by benchmark/spans.py), 'traced_frames' and 'untraced_frames'
(the span frame ids of the stretch's frames and of the window's frames
after it).
A reader that reads one kind's reference (table_bytes: path_diffuse's)
lists that kind's cells under its `workloads` in BENCHMARK.json."""

import sys


def kernel_seconds(ctx, names):
    """(device seconds, activities) of the trace's kernels whose name
    holds one of `names`, over the stretch."""
    spans = [e - s for n, s, e in ctx['stretch'].device
             if any(k in n for k in names)]
    return sum(spans) / 1e6, len(spans)


def per_frame_kernel_seconds(ctx, data):
    """Device seconds a frame of the data's kernels, or None where the
    trace holds none; says on stderr how many launches the trace held
    against the program's counter for the same stretch."""
    secs, held = kernel_seconds(ctx, data['kernels'])
    counted = ctx['stretch'].launches.get(data['launch_counter'])
    print(f"{data['name']}: the trace held {held} launches of "
          f"{'/'.join(data['kernels'])}, kernels.LAUNCHES counted "
          f"{counted} ({data['launch_counter']})", file=sys.stderr)
    if not held:
        return None
    return secs / ctx['stretch'].frames


def table_bytes(ref):
    """Bytes of the scene tables a fused kernel reads, each once, of a
    path_diffuse reference scene."""
    return sum(t.numel() * t.element_size() for t in (
        ref.fp_woop, ref.fp_woop_occ, ref.fp_tri, ref.cast_src, ref.cast_alt,
        ref.cast_quad, ref.cast_occ_quad, ref.fp_light, ref.tri_stair_cdf,
        ref.fp_sph))
