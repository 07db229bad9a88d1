"""Port of ``src/repro/fl/multijob.py`` (copied; imports re-pointed).

Co-scheduling driver: N FLScheduler jobs on ONE shared EventLoop.

Each tenant job is a normal ``FLScheduler`` constructed with
``loop=shared_loop`` and a backend bound to a ``Fabric.job(...)``
handle; the driver bootstraps every job via ``scheduler.prepare``
(respecting per-job ``start_s`` offsets), runs the single clock once,
and stops it when the last job reports finished.  A finished job
quiesces — its timer/dispatch callbacks early-return on the
``finished`` flag — instead of stopping the loop, so the surviving
tenants keep the clock (and the contended links) to themselves.

Jobs interleave on the simulated clock but contend only through the
fabric: when ``FabricSpec.shared_links`` is on, flows from different
jobs traversing the same declared edge share one pipe under the
fabric's admission policy (fifo / priority / fair-share).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.fl.scheduler import AsyncRunReport, EventLoop, FLScheduler


class MultiScheduler:
    """Drive several FLScheduler jobs on one shared EventLoop.

    Usage::

        loop = EventLoop()
        fabric = Fabric(env, spec=FabricSpec(policy="priority",
                                             shared_links=True))
        job_a = fabric.job("a", priority=1)
        ... build FLScheduler(..., loop=loop) per job ...
        multi = MultiScheduler(loop)
        multi.add_job("a", sched_a, payload_a, max_aggregations=20)
        multi.add_job("b", sched_b, payload_b, max_aggregations=20,
                      start_s=30.0)
        reports = multi.run()          # {"a": AsyncRunReport, ...}
    """

    def __init__(self, loop: EventLoop):
        self.loop = loop
        self.jobs: Dict[str, FLScheduler] = {}
        self._prepared: List[tuple] = []  # (name, payload, kwargs)
        self._running = 0

    def add_job(self, name: str, scheduler: FLScheduler, global_payload, *,
                max_aggregations: Optional[int] = None,
                target_effective_updates: Optional[float] = None,
                start_s: float = 0.0) -> None:
        if name in self.jobs:
            raise ValueError(f"duplicate job name {name!r}")
        if scheduler.loop is not self.loop:
            raise ValueError(
                f"job {name!r}: scheduler was not built on this shared loop "
                "(pass loop= to FLScheduler)")
        if max_aggregations is None and target_effective_updates is None:
            raise ValueError(
                f"job {name!r} needs a cap: max_aggregations= or "
                "target_effective_updates= (a capless tenant would never "
                "quiesce and the shared clock would run to until=)")
        self.jobs[name] = scheduler
        self._prepared.append((name, global_payload, dict(
            max_aggregations=max_aggregations,
            target_effective_updates=target_effective_updates,
            start_s=start_s)))

    # ------------------------------------------------------------------
    def _on_job_finished(self, sched: FLScheduler, done_t: float) -> None:
        self._running -= 1
        if self._running <= 0:
            self.loop.stop()

    def run(self, until: float = math.inf) -> Dict[str, AsyncRunReport]:
        if not self._prepared:
            raise ValueError("no jobs added")
        self._running = len(self._prepared)
        for name, payload, kw in self._prepared:
            sched = self.jobs[name]
            sched.on_finished = self._on_job_finished

            def boot(now, *, _s=sched, _p=payload, _kw=kw):
                _s.prepare(_p, **_kw)

            # bootstrap through the loop, NOT synchronously: a job's
            # round-0 broadcast reserves shared pipes, so it must solve
            # in simulated-time order (a t=0 tenant before a t=30 one),
            # not in add_job order
            self.loop.call_at(kw["start_s"], f"job-start:{name}", boot)
        self.loop.run(until=until)
        return {name: self.jobs[name].report() for name in self.jobs}
