"""Reduce the ``torch.profiler`` trace that ``devtrace.reduce`` reads to
what the program's own spans (``repro_torch/obs.py``, the profiler
annotations named ``repro_torch.<span>``) show of the traced part: the
local steps, the runtime calls that launched device work inside them,
the device time of host-to-device copies by the span that issued them,
and the card's idle gaps by the innermost program span open in each."""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from fl_bench.devtrace import TRACED, _union

PREFIX = "repro_torch."
OUTSIDE = "outside"  # a gap's label when no program span is open


@dataclasses.dataclass(frozen=True)
class Event:
    """The fields of one profiler event that the reduction reads."""
    name: str
    start_ns: int
    end_ns: int
    correlation_id: int = 0
    on_device: bool = False
    annotation: bool = False  # a span's projection on the device


def events_of(prof) -> list:
    from torch._C._autograd import DeviceType
    return [Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.correlation_id(), e.device_type() == DeviceType.CUDA,
                  e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def innermost(spans, times) -> list:
    """For each of the ascending ``times``, the name of the innermost of
    ``spans`` (ascending (start, end, name)) open at it, else None."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        out.append(max(active)[2] if active else None)
    return out


def reduce_events(events) -> dict:
    traced = [e for e in events if not e.on_device and e.name == TRACED]
    if not traced:
        raise RuntimeError("the trace holds no traced span")
    lo, hi = traced[0].start_ns, traced[0].end_ns
    spans = sorted((e.start_ns, e.end_ns, e.name[len(PREFIX):])
                   for e in events if not e.on_device
                   and e.name.startswith(PREFIX)
                   and lo <= e.start_ns and e.end_ns <= hi)
    # device work, as devtrace.reduce takes it
    work = [e for e in events if e.on_device and e.end_ns > e.start_ns
            and not e.annotation and not e.name.startswith("fl_bench.")]
    corr_with_work = {e.correlation_id for e in work}
    calls = {e.correlation_id: e.start_ns for e in events
             if not e.on_device and e.name.startswith("cu")
             and e.correlation_id}
    # launches: runtime calls inside a local step that put work on the card
    steps = [(s, e) for s, e, name in spans if name == "client.step"]
    starts = [s for s, _ in steps]
    launches = 0
    for corr, t in calls.items():
        i = bisect.bisect_right(starts, t) - 1
        if corr in corr_with_work and i >= 0 and t <= steps[i][1]:
            launches += 1
    # host-to-device copies by the span that issued them
    copies = sorted((calls[e.correlation_id], e.end_ns - e.start_ns)
                    for e in work if "HtoD" in e.name
                    and e.correlation_id in calls)
    h2d = defaultdict(int)
    for (_, ns), label in zip(copies, innermost(spans, [t for t, _ in
                                                        copies])):
        h2d[label or OUTSIDE] += ns
    # the card's idle gaps in the traced part, by innermost program span
    busy = _union([(max(e.start_ns, lo), min(e.end_ns, hi)) for e in work
                   if e.end_ns > lo and e.start_ns < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = defaultdict(int)
    for (a, b), label in zip(gaps, innermost(spans, [(a + b) // 2
                                                     for a, b in gaps])):
        idle[label or OUTSIDE] += b - a
    return {"steps": len(steps), "launches": launches,
            "h2d_s": {k: v / 1e9 for k, v in h2d.items()},
            "idle_gaps": [[k, v / 1e9] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])],
            "traced_s": (hi - lo) / 1e9}


def reduce(prof) -> dict:
    return reduce_events(events_of(prof))
