"""Spans around the calls into the port's layers, from the benchmark's own
files: each wrapped call is timed by a pair of CUDA events in stream order
and marked for the profiler with `record_function`.

`wrap(obj, attr, name)` replaces the bound method on that one object (an
instance attribute), so only the object the benchmark built is measured and
the port's classes are untouched.  Spans are kept in memory and read after
the window: `ms(name)` gives one duration per call, of the ticks the
profiler did not cover.
"""

from __future__ import annotations

import functools

import torch


class Spans:
    def __init__(self):
        self.tick = -1            # the window's tick now running
        self.profiled: set[int] = set()
        self._open: list[tuple[str, int, object, object]] = []
        self._wrapped: list[tuple[object, str]] = []

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"span.{name}"):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            self._open.append((name, self.tick, start, end))
            return out

        setattr(obj, attr, timed)
        self._wrapped.append((obj, attr))

    def unwrap(self) -> None:
        for obj, attr in self._wrapped:
            delattr(obj, attr)
        self._wrapped.clear()

    def ms(self, name: str) -> list[float]:
        """Durations (ms) of `name`'s calls in ticks >= 0 that the profiler
        did not cover; synchronizes first."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for n, t, s, e in self._open
                if n == name and t >= 0 and t not in self.profiled]
