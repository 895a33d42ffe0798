"""Spans of the program's layers, and device tracing. Port of
lajolla_tpu/utils/profiling.py.

Spans: `with span(name):` around a layer's work records
Span(name, start_ns, end_ns, parent, frame) while the recorder is on:
`parent` is the index (in the list `take()` returns) of the span that
was open around it, or None; `frame` is the id that `frame(name)` gives
every span opened inside one call, a render() of one film, or None
outside any. The recorder is off until `enable()`; off, `span` is one
test of a module flag that returns a shared null context: no clock read,
no allocation, no synchronise. Spans stay in memory until `take()`
drains them. The recorder is one per process and not thread-safe: the
program's layers run on one host thread.

The clock is the host's realtime clock (`time.time_ns`, CLOCK_REALTIME):
the clock that torch.profiler (Kineto) stamps its host and CUDA activities
with on Linux, so that a trace's absolute device times
(`kineto_results.trace_start_ns()` plus each event's relative start) and
the spans lie on one time axis. On an H100 with torch 2.11 and CUDA 12.8
the trace's K1 kernels start 0.09-0.17 ms after their `k1.launch` spans
open and each film's copy to the host runs inside its `render.film_copy`
span (tools/profile_torch_spans.py).

`device_trace` writes a torch.profiler Chrome trace (open it in
chrome://tracing or Perfetto) in place of jax.profiler.trace; unlike
lajolla_tpu's, it lets an exception of the traced region through
(lajolla_tpu's catches it and yields a second time)."""

import contextlib
import os
import time
from typing import NamedTuple, Optional

_clock = time.time_ns
_NULL = contextlib.nullcontext()
_on = False
_spans = []       # [name, start_ns, end_ns, parent, frame], in opening order
_open = []        # indices into _spans of the open spans, innermost last
_frame = None     # the id of the frame being recorded, or None
_frames = 0       # frames begun since the process started


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    frame: Optional[int]


class _Recorded:
    __slots__ = ('name', 'new_frame', 'index', 'outer_frame')

    def __init__(self, name, new_frame):
        self.name = name
        self.new_frame = new_frame

    def __enter__(self):
        global _frame, _frames
        self.outer_frame = _frame
        if self.new_frame:
            _frames += 1
            _frame = _frames
        self.index = len(_spans)
        _spans.append([self.name, _clock(), None,
                       _open[-1] if _open else None, _frame])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        global _frame
        _spans[self.index][2] = _clock()
        _open.pop()
        _frame = self.outer_frame
        return False


def enable():
    """Start recording spans."""
    global _on
    _on = True


def disable():
    """Stop recording spans; those recorded stay until take()."""
    global _on
    _on = False


def enabled():
    return _on


def take():
    """The spans recorded since the last take(), as a list of Span in the
    order they opened; the recorder's list is emptied. Raises while a span
    is open: its parent index would point into the drained list."""
    global _spans
    if _open:
        raise RuntimeError(
            f"take() inside the open span {_spans[_open[-1]][0]!r}")
    out, _spans = [Span(*s) for s in _spans], []
    return out


def span(name):
    """A context that records the span `name` while the recorder is on."""
    if not _on:
        return _NULL
    return _Recorded(name, False)


def frame(name):
    """span(name) that also begins a new frame id for every span opened
    inside it."""
    if not _on:
        return _NULL
    return _Recorded(name, True)


def sync(name, device):
    """While the recorder is on, a span `name` around a synchronise of
    `device`'s current CUDA stream (none on another device), so that the
    wait for queued work is its own span; off, nothing. Call it only right
    before a call that synchronises anyway, so that the device's schedule
    is the same either way."""
    if not _on:
        return
    with _Recorded(name, False):
        if device.type == 'cuda':
            import torch
            torch.cuda.current_stream(device).synchronize()


@contextlib.contextmanager
def recording():
    """The recorder on for the enclosed block and off after it; yields a
    list that receives, when the block ends, what take() gives."""
    spans = []
    enable()
    try:
        yield spans
    finally:
        disable()
        spans.extend(take())


def seconds_by_name(spans):
    """{name: total seconds} of the spans."""
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return out


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the enclosed region and write it to log_dir/trace.json;
    yields the torch.profiler.profile object."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
