"""Runtime calls that put work on the card (kernels, copies, memsets)
issued inside the program's ``client.step`` span, per local step, in the
traced part (``fl_bench/progtrace.py``)."""


def read(run):
    t = getattr(run, "program_trace", None)
    if t is None or run.card is None or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
