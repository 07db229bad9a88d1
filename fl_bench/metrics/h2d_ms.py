"""Device ms per local step of the host-to-device copies issued inside
the program's ``client.input.h2d`` span (the batch), in the traced part
(``fl_bench/progtrace.py``). The received model reaches the card in the
wire's ``wire.place``, which this leaves out."""


def read(run):
    t = getattr(run, "program_trace", None)
    if t is None or run.card is None or not t["steps"]:
        return None
    return t["h2d_s"].get("client.input.h2d", 0.0) / t["steps"] * 1e3
