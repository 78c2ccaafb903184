"""Accumulating wall-clock timer (reference surface: utils/timer.py:8-44).

start/pause/stop/report with a recorded duration list; ``duration`` is the
running total, ``count`` the number of completed start→stop spans. For
device-side timing prefer utils/profiler (jax.profiler traces) — wall clock
around dispatches measures the host, not the device.
"""

import time

import numpy as np


class Timer:

    def __init__(self, name="timer"):
        self.name = name
        self.reset()

    def reset(self):
        self._durations = []
        self._running = 0.0
        self._start = None

    def start(self):
        self._start = time.time()
        return self

    def pause(self):
        if self._start is not None:
            self._running += time.time() - self._start
            self._start = None

    def stop(self):
        self.pause()
        self._durations.append(self._running)
        self._running = 0.0

    @property
    def duration(self):
        extra = (time.time() - self._start) if self._start is not None else 0.0
        return float(np.sum(self._durations) + self._running + extra)

    @property
    def count(self):
        return len(self._durations)

    def report(self):
        print("[%s] total %.6fs over %d spans (mean %.6fs)" % (
            self.name, self.duration, self.count,
            self.duration / self.count if self.count else float("nan")))
