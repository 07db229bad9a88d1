"""Host ms per aggregation in the runtime's own code: the exclusive time
of the program's ``round.sync`` (a lockstep round) and ``runtime.event``
(each event of the event-driven loop) spans, that is their time less the
client, wire, codec and aggregation spans nested in them, over the
untraced rest of the window (``repro_torch/obs.py``)."""

SPANS = ("round.sync", "runtime.event")


def read(run):
    snap = getattr(run, "program", None)
    if not snap:
        return None
    n = snap["counters"].get("round.aggregations", 0)
    if not n:
        return None
    excl = sum(snap["spans"].get(s, {}).get("excl_s", 0.0) for s in SPANS)
    return excl / n * 1e3
