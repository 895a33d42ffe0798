"""The program's spans read against a device trace.

lajolla_tpu_torch records spans of its layers while its recorder is on
(`lajolla_tpu_torch.utils.profiling`): (name, start_ns, end_ns, parent,
frame), `parent` the index of the enclosing span, `frame` the id shared by
the spans of one render(), all on the host's realtime clock. torch.profiler
stamps the device's activities on the same clock: the trace's start
(`kineto_results.trace_start_ns()`) plus each activity's relative time. A
SpanStretch keeps that start, so that the device's idle time can be named
by what the host was doing meanwhile.

Nothing here imports the program: spans are plain tuples, read by field
position, so the arithmetic holds whatever the program's version."""

import statistics
import time

from benchmark.trace import Stretch

OUTSIDE = 'outside render()'
NAME, START, END, PARENT, FRAME = range(5)


class SpanStretch(Stretch):
    """A Stretch that also keeps, on the realtime clock, its own start and
    end (`lo_ns`, `hi_ns`, after the synchronise at each end) and the
    trace's start (`trace_start_ns`). Where the run recorded the program's
    spans, `spans` holds them, and the breakdown names each idle gap by the
    span the host was in."""

    spans = None

    def start(self):
        super().start()
        self.lo_ns = time.time_ns()

    def stop(self, frames):
        prof = self.prof
        super().stop(frames)
        self.hi_ns = self.lo_ns + round(self.wall_s * 1e9)
        self.trace_start_ns = prof.profiler.kineto_results.trace_start_ns()

    def device_ns(self):
        """(name, start_ns, end_ns) of every device activity on the
        realtime clock."""
        t0 = self.trace_start_ns
        return [(n, t0 + round(s * 1e3), t0 + round(e * 1e3))
                for n, s, e in self.device]

    def breakdown(self, top=10):
        out = super().breakdown(top)
        if self.spans:
            out['idle_gaps'] = gaps(self.spans, self.device_ns(),
                                    round(self.wall_s * 1e9), top)
        return out


def render_segments(spans):
    """The host's time inside render() spans, cut wherever the innermost
    open span changes: sorted [(start_ns, end_ns, name of that span)]."""
    children = {}
    for i, s in enumerate(spans):
        if s[PARENT] is not None:
            children.setdefault(s[PARENT], []).append(i)
    out = []

    def walk(i):
        s, t = spans[i], spans[i][START]
        for c in children.get(i, ()):
            if spans[c][START] > t:
                out.append((t, spans[c][START], s[NAME]))
            walk(c)
            t = max(t, spans[c][END])
        if s[END] > t:
            out.append((t, s[END], s[NAME]))
    for i, s in enumerate(spans):
        if s[PARENT] is None and s[NAME] == 'render':
            walk(i)
    return sorted(out)


def idle_intervals(device, lo, hi):
    """Sorted [(start, end)] inside [lo, hi] where no device activity
    (name, start, end) runs."""
    out, t = [], lo
    for _, s, e in sorted(device, key=lambda d: d[1]):
        s, e = min(max(s, lo), hi), min(e, hi)
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _split(segments, a, b, j=0):
    """({label: ns} of [a, b) over the segments from index j on, OUTSIDE
    for what none covers; the first index that may still reach past b)."""
    while j < len(segments) and segments[j][1] <= a:
        j += 1
    got, covered, k = {}, 0, j
    while k < len(segments) and segments[k][0] < b:
        part = min(b, segments[k][1]) - max(a, segments[k][0])
        if part > 0:
            got[segments[k][2]] = got.get(segments[k][2], 0) + part
            covered += part
        k += 1
    if b - a > covered:
        got[OUTSIDE] = got.get(OUTSIDE, 0) + (b - a - covered)
    return got, j


def idle_by_span(spans, device, lo, hi):
    """{name of the innermost open span, or OUTSIDE: device-idle ns} over
    [lo, hi]."""
    segments = render_segments(spans)
    out, j = {}, 0
    for a, b in idle_intervals(device, lo, hi):
        got, j = _split(segments, a, b, j)
        for k, v in got.items():
            out[k] = out.get(k, 0) + v
    return out


def gaps(spans, device, wall_ns, top=10):
    """The longest idle gaps between device activities, [[name, seconds]],
    each named 'host in <span>, before <activity>' by the span that holds
    most of it (or 'host outside render(), before ...'), and the
    stretch's idle time before its first and after its last activity as
    one entry, as Stretch.breakdown gives them without spans."""
    segments = render_segments(spans)
    out, end = [], None
    for name, s, e in sorted(device, key=lambda d: d[1]):
        if end is not None and s > end:
            got, _ = _split(segments, end, s)
            where = max(got, key=got.get)
            where = OUTSIDE if where == OUTSIDE else f'in {where}'
            out.append([f'host {where}, before {name}', (s - end) / 1e9])
        end = e if end is None else max(end, e)
    if device:
        span = end - min(s for _, s, _ in device)
        out.append(['host, before the first and after the last device '
                    'activity', max(wall_ns - span, 0) / 1e9])
    return sorted(out, key=lambda g: -g[1])[:top]


def self_ns(spans):
    """Each span's duration less its children's, by index."""
    own = [s[END] - s[START] for s in spans]
    for s in spans:
        if s[PARENT] is not None:
            own[s[PARENT]] -= s[END] - s[START]
    return own


def per_frame_ns(spans, frames, name, own=False):
    """{frame: ns} of the spans named `name` summed in each of `frames`
    (their self time where `own`); a frame without one reads 0."""
    out = {f: 0 for f in frames}
    ns = self_ns(spans) if own else [s[END] - s[START] for s in spans]
    for s, d in zip(spans, ns):
        if s[NAME] == name and s[FRAME] in out:
            out[s[FRAME]] += d
    return out


def median_ms(spans, frames, name, own=False):
    """The median over `frames` of per_frame_ns, in ms, or None where no
    frame holds such a span."""
    if not any(s[NAME] == name and s[FRAME] in frames for s in spans):
        return None
    ns = per_frame_ns(spans, frames, name, own)
    return statistics.median(ns.values()) / 1e6


def render_frames(spans):
    """The frame ids of the render() spans, in order."""
    return [s[FRAME] for s in spans if s[NAME] == 'render']


def setup_s(spans):
    """Seconds of scene.parse, scene.compile and scene.upload, or None
    where none was recorded."""
    parts = [s[END] - s[START] for s in spans
             if s[NAME] in ('scene.parse', 'scene.compile', 'scene.upload')]
    return sum(parts) / 1e9 if parts else None


def clock_pairs(spans, device):
    """Offsets in ns between spans and the device activities they issued,
    paired in order: each `k1.launch` span's start against its
    render_fused_kernel's start (on one clock the kernel starts after its
    launch: offset > 0), and each `render.film_copy` span against its
    film's copy to the host, the longest device-to-host copy of each frame:
    the copy's start against the span's (> 0: the device was idle, so the
    copy starts as soon as it is issued) and its end against the span's end
    (< 0: the copy ends inside the span); and each `render.film_wait`
    span's end against the end of the device work queued before that copy
    (< 0 and close to it where the wait had work to wait for, as K1's
    frames have). {kind: [offsets]}."""
    out = {}
    launches = [s for s in spans if s[NAME] == 'k1.launch']
    k1 = sorted((d for d in device if 'render_fused_kernel' in d[0]),
                key=lambda d: d[1])
    if launches and len(launches) == len(k1):
        out['k1_start_after_launch'] = [d[1] - s[START]
                                        for s, d in zip(launches, k1)]
    copies = [s for s in spans if s[NAME] == 'render.film_copy']
    dtoh = sorted((d for d in device if 'DtoH' in d[0]),
                  key=lambda d: d[1] - d[2])[:len(copies)]
    if copies and len(dtoh) == len(copies):
        dtoh.sort(key=lambda d: d[1])
        out['film_copy_start_after_span_start'] = [
            d[1] - s[START] for s, d in zip(copies, dtoh)]
        out['film_copy_end_after_span_end'] = [
            d[2] - s[END] for s, d in zip(copies, dtoh)]
        waits = [s for s in spans if s[NAME] == 'render.film_wait']
        if len(waits) == len(dtoh):
            ordered = sorted(device, key=lambda d: d[1])
            queued = [max((e for _, _, e in ordered[:ordered.index(d)]),
                          default=d[1]) for d in dtoh]
            out['queued_work_end_after_wait_end'] = [
                q - s[END] for s, q in zip(waits, queued)]
    return out
