"""Port of ``src/repro/fl/``: the sync FL round (server, clients,
FedAvg), the event-driven runtime (scheduler and the fedbuff / semisync /
hier / vertical strategies), the multi-tenant scheduler and the fault
plans."""
from repro_torch.fl.aggregator import (fedavg, fedavg_quantized,
                                       staleness_weight)
from repro_torch.fl.async_strategies import (AggregationStrategy,
                                             FedBuffStrategy,
                                             HierarchicalStrategy,
                                             SemiSyncStrategy, make_strategy)
from repro_torch.fl.client import FLClient
from repro_torch.fl.fault import (AvailabilityTrace, FaultPlan,
                                  make_availability)
from repro_torch.fl.scheduler import (AsyncRunReport, EventLoop,
                                      FLScheduler, UpdateRecord)
from repro_torch.fl.server import FLServer, RoundReport, quorum_cutoff
from repro_torch.fl.vertical import (SplitPlan, VerticalLive,
                                     VerticalStrategy, bottom_fraction,
                                     sim_activation_nbytes)

__all__ = ["FLServer", "FLClient", "RoundReport", "fedavg", "fedavg_quantized",
           "staleness_weight", "quorum_cutoff",
           "FLScheduler", "EventLoop", "AsyncRunReport", "UpdateRecord",
           "AggregationStrategy", "FedBuffStrategy", "SemiSyncStrategy",
           "HierarchicalStrategy", "make_strategy", "AvailabilityTrace",
           "FaultPlan", "make_availability", "SplitPlan", "VerticalLive",
           "VerticalStrategy", "bottom_fraction", "sim_activation_nbytes"]
