"""The port's own spans and counters.

    @obs.spanned("wire.encode")
    def encode(...): ...

    with obs.span("wire.place"):
        ...
    obs.count("round.aggregations")

Off by default, and then close to free: ``span`` returns one shared
no-op context manager (no clock read, no allocation), a ``spanned``
function calls straight through and ``count`` returns at once.
``enable()`` starts a fresh record. A span then reads
``time.perf_counter_ns()`` at enter and exit; a per-thread stack of open
spans gives each its exclusive time, its time less that of the spans
nested in it. While a ``torch.profiler`` records, and only then, a span
also opens ``record_function("repro_torch." + name)``, so it stands on
the same timeline as the device's events. A span never synchronises the
card, allocates on it or changes a result.
"""
from __future__ import annotations

import functools
import threading
import time

import torch

PREFIX = "repro_torch."  # the profiler annotation's prefix

_on = False
_spans: dict = {}  # name -> [n, inclusive ns, exclusive ns]
_counters: dict = {}
_local = threading.local()  # .stack: this thread's open spans
_lock = threading.Lock()  # guards _spans and _counters


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        note = None
        if torch._C._autograd._profiler_enabled():
            note = torch.profiler.record_function(PREFIX + self.name)
            note.__enter__()
        # [name, start ns, ns of nested spans, profiler note]
        _stack().append([self.name, time.perf_counter_ns(), 0, note])

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        st = _stack()
        name, t0, nested, note = st.pop()
        dt = t1 - t0
        if st:
            st[-1][2] += dt
        with _lock:
            rec = _spans.get(name)
            if rec is None:
                rec = _spans[name] = [0, 0, 0]
            rec[0] += 1
            rec[1] += dt
            rec[2] += dt - nested
        if note is not None:
            note.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager timing ``name`` (a no-op while off)."""
    if not _on:
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each of its calls runs in
    ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _on:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing while off)."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the spans and counters on, from a fresh record."""
    global _on
    reset()
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Clear the record. Spans open on this thread restart their clocks
    here, so what they record is the time after the reset."""
    with _lock:
        _spans.clear()
        _counters.clear()
    now = time.perf_counter_ns()
    for frame in _stack():
        frame[1], frame[2] = now, 0


def snapshot() -> dict:
    """-> {"spans": {name: {"n", "incl_s", "excl_s"}}, "counters":
    {name: int}}; empty before the first ``enable()``."""
    with _lock:
        spans = {name: {"n": n, "incl_s": incl / 1e9, "excl_s": excl / 1e9}
                 for name, (n, incl, excl) in _spans.items()}
        return {"spans": spans, "counters": dict(_counters)}
