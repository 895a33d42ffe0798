"""The traced stretch of a `--trace 1` run: torch.profiler around a few
frames inside the window, read into device activities (kernels, copies,
sets) and the stretch's wall time, and the breakdown that the result line
carries.

The profiler traces the device's activity alone, not the host's
operations: recording every torch operation on the host costs it tens of
microseconds an operation, which would double the frame of a cell that
issues thousands of them and so read the profiler's cost as idle time."""

import time

from benchmark.stats import busy_seconds


class Stretch:
    """Profile the frames between start() and stop(); then `device`
    holds (name, start_us, end_us) of every device activity, `wall_s` the
    stretch's length by the host's clock between a synchronise at each
    end, `frames` the frames it holds, and `launches` what the program's
    launch counters (`counters()`, a dict) counted over it."""

    def __init__(self, torch, counters=dict):
        self.torch = torch
        self.counters = counters
        self.launches = {}
        self.prof = None
        self.device = []
        self.wall_s = None
        self.frames = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._launches0 = dict(self.counters())
        self._t0 = time.perf_counter()

    def stop(self, frames):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.launches = {k: v - self._launches0.get(k, 0)
                         for k, v in self.counters().items()}
        self.prof.__exit__(None, None, None)
        self.frames = frames
        from torch.autograd import DeviceType
        self.device = [(e.name, e.time_range.start, e.time_range.end)
                       for e in self.prof.events()
                       if e.device_type == DeviceType.CUDA]
        self.prof = None

    def window_s(self):
        return self.wall_s

    def busy_s(self):
        return busy_seconds([(s, e) for _, s, e in self.device])

    def breakdown(self, top=10):
        """{'device_ops': the device activities that took most time,
        [[name, seconds]]; 'idle_gaps': the longest gaps between device
        activities, each named by the activity the host issued next,
        [[name, seconds]], with the stretch's idle time before its first
        and after its last activity as one entry}."""
        by_name = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for name, s, e in sorted(self.device, key=lambda d: d[1]):
            if end is not None and s > end:
                gaps.append([f'host, before {name}', (s - end) / 1e6])
            end = e if end is None else max(end, e)
        if self.device:
            span = (end - min(s for _, s, _ in self.device)) / 1e6
            gaps.append(['host, before the first and after the last '
                         'device activity', max(self.wall_s - span, 0.0)])
        gaps = sorted(gaps, key=lambda g: -g[1])[:top]
        return {'device_ops': [[k, v] for k, v in ops], 'idle_gaps': gaps}
