"""Progress reporting (the analogue of the reference's ProgressReporter,
src/progress_reporter.h:8-38 — there a mutex-guarded tile counter; here a
plain callback over render blocks, since the unit of work is one device
launch rather than one film tile)."""

import sys
import time


class ProgressReporter:
    def __init__(self, total, label="render", stream=sys.stderr,
                 enabled=True):
        self.total = max(total, 1)
        self.done = 0
        self.label = label
        self.stream = stream
        self.enabled = enabled
        self.t0 = time.time()

    def update(self, n=1):
        self.done += n
        if not self.enabled:
            return
        frac = self.done / self.total
        dt = time.time() - self.t0
        eta = dt / max(frac, 1e-9) * (1 - frac)
        self.stream.write(
            f"\r{self.label}: {100 * frac:5.1f}% "
            f"({self.done}/{self.total}) elapsed {dt:6.1f}s eta {eta:6.1f}s")
        self.stream.flush()

    def finish(self):
        if self.enabled:
            self.stream.write("\n")
            self.stream.flush()
