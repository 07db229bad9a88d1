"""Reduce a ``torch.profiler`` trace of part of the window to what the
per-layer metrics read: the seconds in which the card ran anything, the
device seconds inside each of the benchmark's op ranges, the device ops
that took most time, and the idle gaps by what the host was doing."""
from __future__ import annotations

import bisect
from collections import defaultdict

from torch._C._autograd import DeviceType

TRACED = "fl_bench.traced"  # the annotation that spans the traced part


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def short_name(kernel: str) -> str:
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def reduce(prof) -> dict:
    events = prof.profiler.kineto_results.events()
    device, notes, launches = [], [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            # a span's projection on the device's timeline is no work
            if e.duration_ns() > 0 and not e.is_user_annotation() \
                    and not e.name().startswith("fl_bench."):
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name(), e.correlation_id()))
        elif e.name().startswith("fl_bench."):
            notes.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()))
        elif e.name().startswith("cu") and e.correlation_id():
            # a runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...): the
            # device work it starts carries its correlation id
            launches.append((e.start_ns(), e.correlation_id()))
    traced = [n for n in notes if n[2] == TRACED]
    if not traced:
        raise RuntimeError("the trace holds no traced span")
    lo, hi = traced[0][0], traced[0][1]
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _, _ in device
                   if e > lo and s < hi])
    per_op = defaultdict(int)
    for s, e, name, _ in device:
        if e > lo and s < hi:
            per_op[short_name(name)] += min(e, hi) - max(s, lo)
    # a range's device time: the work its own runtime calls started
    launches.sort()
    times = [t for t, _ in launches]
    by_corr = defaultdict(list)
    for s, e, _, corr in device:
        by_corr[corr].append((s, e))
    ranges = defaultdict(int)
    for s, e, name in notes:
        if name.startswith("fl_bench.range."):
            i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            work = [iv for _, c in launches[i:j] for iv in by_corr.get(c, ())]
            ranges[name[len("fl_bench.range."):]] += sum(
                b - a for a, b in _union(work))
    # idle gaps, each named by the innermost span open at its middle
    spans = sorted(n for n in notes if n[2] != TRACED
                   and not n[2].startswith("fl_bench.range."))
    gaps = defaultdict(int)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    active, i = [], 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [n for n in active if n[1] >= mid]
        label = (max(active)[2][len("fl_bench."):] if active
                 else "fl_runtime")
        gaps[label] += g1 - g0
    top = lambda d: [[k, v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "traced_s": (hi - lo) / 1e9,
            "range_device_s": {k: v / 1e9 for k, v in ranges.items()},
            "device_ops": top(per_op), "idle_gaps": top(gaps)}
