"""Synchronised host ms per aggregation in the aggregator's calls:
``fedavg`` (sync rounds and the event-driven hub) and ``merge_global``."""


def read(run):
    n = run.counts.get("aggregations", 0)
    return run.spans.get("aggregate", 0.0) / n * 1e3 if n else None
