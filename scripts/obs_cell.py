"""Run one cell of the benchmark with the program's own tracer
(``repro_torch/obs.py``) on over a traced run's window, and the four
program metrics among the cell's per-layer ones:

    python3 scripts/obs_cell.py --workload <name> --seed <n> \
        --seconds <s> --trace 1

from the root of a checkout, on the card. It runs ``fl_bench/run.py``
unchanged, with four hooks around its harness: ``obs.enable()`` when a
traced run opens its window, ``obs.reset()`` where the traced part ends
and the probe's spans restart, ``obs.snapshot()`` and ``obs.disable()``
when the window closes; the run's view then carries the snapshot
(``program``) and ``fl_bench/progtrace.py``'s reduction of the profiled
part (``program_trace``), which ``fl_bench/metrics/launches_per_step.py``,
``h2d_ms.py``, ``runtime_ms.py`` and ``wire_gbps.py`` read. Standard error gets one line
with the card's idle gaps by program span, the host-to-device copies by
span and the snapshot.
"""
import time

T0 = time.perf_counter()

import contextlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
METRICS = [
    {"name": "launches_per_step", "unit": "launches", "better": "lower",
     "source": "device_trace", "layer": "client", "moves": "round_s"},
    {"name": "h2d_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "client input", "moves": "round_s"},
    {"name": "runtime_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "round", "moves": "round_s"},
    {"name": "wire_gbps", "unit": "GB/s", "better": "higher",
     "source": "program_span", "layer": "wire", "moves": "round_s"},
]


@contextlib.contextmanager
def hooks():
    """The four hooks around ``fl_bench.harness``'s window, for the
    ``with`` block; yields the list the run's views are added to."""
    from fl_bench import harness, progtrace
    from repro_torch import obs
    W, V = harness.Window, harness.RunView
    saved = W.open, W.stop_profile, W.close, V.__init__
    open_, stop, close, view = saved
    views = []

    def opened(self, sched):
        open_(self, sched)
        if self.trace:
            obs.enable()

    def stopped(self):
        stop(self)
        obs.reset()

    def closed(self, sched):
        close(self, sched)
        self.program = obs.snapshot() if obs.enabled() else None
        obs.disable()

    def viewed(self, probe, window, reduced, flops, card):
        view(self, probe, window, reduced, flops, card)
        self.program = getattr(window, "program", None)
        self.program_trace = (progtrace.reduce(window.prof)
                              if window.prof is not None else None)
        if self.program_trace is not None:
            t = self.program_trace
            harness.log(f"idle gaps by program span: {t['idle_gaps']}; "
                        f"host-to-device copies by span: {t['h2d_s']}; "
                        f"program: {self.program}")
        views.append(self)

    W.open, W.stop_profile, W.close, V.__init__ = \
        opened, stopped, closed, viewed
    try:
        yield views
    finally:
        W.open, W.stop_profile, W.close, V.__init__ = saved
        obs.disable()


def with_metrics(cell):
    """The cell with the four program metrics among its per-layer
    ones."""
    from fl_bench.cell import load_reader
    for m in METRICS:
        cell.per_layer.append(m)
        cell.readers[m["name"]] = load_reader(
            ROOT / "fl_bench" / "metrics" / f"{m['name']}.py")
    return cell


def main(argv=None) -> int:
    """``fl_bench/run.py``'s main, whose cell gains the four metrics and
    whose harness runs inside the hooks."""
    sys.path.insert(0, str(ROOT))
    from fl_bench import cell as cells
    from fl_bench import run
    run.T0 = T0
    resolve = cells.resolve
    with contextlib.ExitStack() as stack:
        def resolved(root, workload):
            stack.enter_context(hooks())  # after run.py's set-up
            return with_metrics(resolve(root, workload))
        cells.resolve = resolved
        try:
            return run.main(argv)
        finally:
            cells.resolve = resolve


if __name__ == "__main__":
    sys.exit(main())
