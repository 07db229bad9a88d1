"""Synchronised wall ms of one local SGD step (forward, backward, update)
of ``launch/fl_train.make_train_fn``, as ``FLClient.local_train`` calls it."""


def read(run):
    n = run.counts.get("train_steps", 0)
    return run.spans.get("train_step", 0.0) / n * 1e3 if n else None
