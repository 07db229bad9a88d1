"""The wire's host rate in GB/s: the bytes through its serialize and
deserialize steps, both ways (the program's ``wire.bytes`` counter), over
the exclusive seconds of the ``wire.serialize``, ``wire.deserialize`` and
``wire.place`` spans (``repro_torch/obs.py``), from the program's snapshot
of the untraced rest of the window. Nothing where the program has no such
counter or spans."""

SPANS = ("wire.serialize", "wire.deserialize", "wire.place")


def read(run):
    snap = getattr(run, "program", None)
    if not snap:
        return None
    nbytes = snap["counters"].get("wire.bytes", 0)
    secs = sum(snap["spans"].get(s, {}).get("excl_s", 0.0) for s in SPANS)
    if not nbytes or secs <= 0:
        return None
    return nbytes / secs / 1e9
