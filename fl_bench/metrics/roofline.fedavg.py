"""FedAvg's share of the card's memory roofline: the logical bytes of
every ``ops.fedavg_aggregate`` call in the traced part (each update read
once, the aggregate written once; ``fl_bench/counts.py``) over the
memory rate, divided by the device time of all work launched inside the
profiler ranges around those calls."""
from fl_bench import counts


def read(run):
    if run.trace is None or run.card is None:
        return None
    dev_s = run.trace["range_device_s"].get("fedavg", 0.0)
    nbytes = run.range_bytes.get("fedavg", 0)
    if dev_s <= 0 or nbytes <= 0:
        return None
    return counts.bound_s(nbytes, run.card) / dev_s * 100.0
