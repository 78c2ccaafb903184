"""Profiling helpers — the device-side answer to the reference's wall-clock
Timer (see SURVEY.md §5 "tracing/profiling").

``trace(logdir)`` wraps a block in a jax.profiler trace (view in
TensorBoard/XProf: per-op device timelines, HLO attribution).
``annotate(name)`` labels a region so kernels show up under a readable name.
``StepTimer`` measures steady-state steps/s the honest way: block on the
device result before reading the clock.
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir="/tmp/tinynn_trace"):
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Usable as decorator or context manager."""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Times N dispatches of a step function, blocking once at the end.

    Usage::

        t = StepTimer()
        out = None
        with t.span(n_steps):
            for _ in range(n_steps):
                out = step()
        t.block_on(out)
        print(t.steps_per_sec)
    """

    def __init__(self):
        self.elapsed = 0.0
        self.n = 0

    @contextlib.contextmanager
    def span(self, n):
        start = time.perf_counter()
        yield
        self._pending = (start, n)

    def block_on(self, out):
        jax.block_until_ready(out)
        start, n = self._pending
        self.elapsed += time.perf_counter() - start
        self.n += n

    @property
    def steps_per_sec(self):
        return self.n / self.elapsed if self.elapsed else float("inf")

    @property
    def ms_per_step(self):
        return 1000.0 * self.elapsed / self.n if self.n else float("nan")
