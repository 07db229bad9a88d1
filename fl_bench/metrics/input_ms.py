"""Host ms per local step spent drawing the batch
(``SiloDataset.batches``) and moving it, and the received tree, to the
card (``fl/client._on``)."""


def read(run):
    n = run.counts.get("train_steps", 0)
    return run.spans.get("input", 0.0) / n * 1e3 if n else None
