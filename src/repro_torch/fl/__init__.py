"""Port of ``src/repro/fl/``: the sync FL round (server, clients, FedAvg)
and the fault plans; the event-driven runtime arrives with a later
slice."""
from repro_torch.fl.aggregator import fedavg, staleness_weight
from repro_torch.fl.client import FLClient
from repro_torch.fl.fault import (AvailabilityTrace, FaultPlan,
                                  make_availability)
from repro_torch.fl.server import FLServer, RoundReport, quorum_cutoff

__all__ = ["FLServer", "FLClient", "RoundReport", "fedavg",
           "staleness_weight", "quorum_cutoff", "AvailabilityTrace",
           "FaultPlan", "make_availability"]
