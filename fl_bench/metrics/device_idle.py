"""Share of the traced part of the window in which no operation ran on
the card (``torch.profiler``'s device events, merged)."""


def read(run):
    if run.trace is None or run.card is None or run.trace["traced_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["traced_s"]) * 100.0
