"""Nearest-rank 95th percentile of the updates begun and completed in the
untraced rest of the window: wall ms from a client's ``recv`` of the
global model to the server holding its decoded update, as
``update_p95_ms`` takes it end to end. The buffered async cell reports it
here: there the host's speed from run to run moves it more than half of
any bound allowed."""
from fl_bench.harness import p95


def read(run):
    return p95(run.update_ms) if run.update_ms else None
