"""The harness's host spans around its calls into the program's layers.

Off in a run with ``--trace 0``: a span is then a null context and a
wrapped function the function itself, so the end-to-end metrics are taken
with tracing off.  In a traced run each span records its host-clock
duration and is also a ``torch.profiler.record_function`` range named
``portbench.<name>``, so the trace can say what the host was doing while
the device sat idle.
"""

from __future__ import annotations

import contextlib
import functools
import time

PREFIX = "portbench."


class Spans:
    def __init__(self, on: bool):
        self.on = on
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def _span(self, name: str):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        try:
            with record_function(PREFIX + name):
                yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def __call__(self, name: str):
        """A context that is the span ``name``."""
        return self._span(name) if self.on else contextlib.nullcontext()

    def wrap(self, fn, name: str):
        """``fn`` inside the span ``name`` on every call."""
        if not self.on:
            return fn

        @functools.wraps(fn)
        def spanned(*a, **k):
            with self._span(name):
                return fn(*a, **k)
        return spanned
