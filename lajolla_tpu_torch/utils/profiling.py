"""Wall-clock phase timing and device tracing. Port of
lajolla_tpu/utils/profiling.py.

The reference exposes a bare Timer printed around parse/render phases
(src/timer.h:10-20, main.cpp:34-42). Here: a context-manager Timer with
the same role, and `device_trace` over torch.profiler in place of
jax.profiler.trace: it records the host and, where CUDA is available,
the device, and writes a Chrome trace (open it in chrome://tracing or
Perfetto). Unlike lajolla_tpu's, it lets an exception of the traced
region through (lajolla_tpu's catches it and yields a second time)."""

import contextlib
import os
import time


class Timer:
    def __init__(self, label=None, report=None):
        self.label = label
        self.report = report
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.report:
            self.report(f"{self.label}: {self.elapsed:.3f}s")
        elif self.label:
            print(f"{self.label}: {self.elapsed:.3f}s")
        return False


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
