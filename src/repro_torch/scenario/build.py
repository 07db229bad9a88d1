"""Port of ``src/repro/scenario/build.py`` (copied; imports re-pointed).

Scenario -> runtime: one place that turns the declarative spec into
the live objects (environment graph, fabric + fault model, object store,
backends). Every entry point — ``fl_train``, the paper-figure benchmarks,
tests — goes through here, so the spec really is the single description
from CLI to fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.netsim import NCAL, Environment, LinkFaultModel
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.transport import Fabric
from repro_torch.scenario.spec import Scenario


@dataclasses.dataclass
class Runtime:
    """The built deployment a scenario describes."""
    scenario: Scenario
    env: Environment
    fabric: Fabric
    store: ObjectStore

    def make_backend(self, host_id: str, *, compression=None,
                     chunk_mb: Optional[float] = None, **kw):
        """A backend on this runtime's fabric carrying the scenario's
        channel spec. ``compression`` defaults to the spec's payload
        codec; pass ``compression=None`` explicitly via
        ``compression="none"`` when a path must stay uncompressed."""
        from repro_torch.core.backends import make_backend
        ch = self.scenario.channel
        comp = ch.compression if compression is None else compression
        return make_backend(
            ch.backend, self.env, self.fabric, host_id, store=self.store,
            compression=None if comp in ("", "none") else comp,
            wire_codec=ch.wire_codec,
            chunk_mb=ch.chunk_mb if chunk_mb is None else chunk_mb, **kw)


def fault_model_for(scenario: Scenario) -> Optional[LinkFaultModel]:
    """The deterministic fault injector the spec asks for (None when the
    scenario is fault-free — the exact legacy timing path)."""
    f = scenario.faults
    host_bo: Dict[str, list] = {}
    edge_bo: Dict[tuple, list] = {}
    for b in f.all_blackouts():
        window = (float(b.t0), float(b.t1))
        if b.dst == "*":
            # per-host form: every link touching src goes dark — this is
            # LinkFaultModel's original blackout machinery
            host_bo.setdefault(b.src, []).append(window)
        else:
            edge_bo.setdefault((b.src, b.dst), []).append(window)
            if b.symmetric:
                edge_bo.setdefault((b.dst, b.src), []).append(window)
    if f.link_loss <= 0.0 and not host_bo and not edge_bo:
        return None
    return LinkFaultModel(chunk_loss_rate=f.link_loss,
                          max_retries=f.max_retries,
                          nack_rtts=f.nack_rtts, seed=scenario.seed,
                          blackouts=host_bo, edge_blackouts=edge_bo)


def build_runtime(scenario: Scenario) -> Runtime:
    """Validate + build the deployment: topology graph, fabric (with the
    fault model installed), object store, endpoints registered."""
    scenario.validate()
    env = scenario.topology.build()
    fabric = Fabric(env, fault_model=fault_model_for(scenario))
    store = ObjectStore(NCAL, fail_rate=scenario.faults.store_fail_rate)
    for h in [env.server] + list(env.clients):
        fabric.register(h.host_id)
    return Runtime(scenario, env, fabric, store)
