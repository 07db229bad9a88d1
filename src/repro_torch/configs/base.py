"""Port of ``src/repro/configs/base.py``: ``FLConfig`` and its one
conversion to a ``Scenario``. ``ModelConfig`` and the LM-stack configs
arrive with the LM slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Cross-silo federated learning round configuration."""

    num_clients: int = 7
    clients_per_round: int = 7
    local_epochs: int = 1
    local_steps: int = 10
    rounds: int = 5
    backend: str = "grpc+s3"
    # topology preset (scenario.TOPOLOGY_PRESETS): the legacy trio plus
    # the graph-native star | ring | multi_hub
    environment: str = "geo_distributed"
    quorum_fraction: float = 1.0  # server aggregates once this fraction reported
    round_deadline_s: float = 0.0  # 0 = no deadline (wait for quorum only)
    server_lr: float = 1.0
    seed: int = 0

    # event-driven runtime (fl/scheduler.py; mode != "sync" selects a
    # strategy from fl/async_strategies.py)
    mode: str = "sync"  # sync | fedbuff | semisync | hier | vertical
    buffer_k: int = 0  # fedbuff merge buffer; 0 -> max(2, num_clients // 2)
    staleness_exponent: float = 0.5  # alpha in the (1+s)^-alpha discount
    max_staleness: int = 0  # discard updates staler than this; 0 = keep all
    # FedAsync-style adaptivity: scale alpha by each update's percentile
    # rank among observed staleness (fl/async_strategies.py)
    staleness_adaptive: bool = False
    # fleet-scale knobs (fl/scheduler.py): seeded K-of-N cohort sampling
    # for fedbuff/semisync (0 = whole fleet), and streaming hub
    # aggregation (fold updates into one O(model) accumulator instead of
    # buffering O(clients) payloads at the server)
    cohort_k: int = 0
    streaming_hub: bool = False

    # vertical / split FL (fl/vertical.py; mode == "vertical"): layer
    # boundary of the bottom/top cut, per-batch exchanges per round, and
    # the codec on the activation/gradient wires
    cut_layer: int = 1
    batches_per_round: int = 8
    activation_codec: str = "none"

    # wire pipeline (core/channel.py): gradient compression on the client
    # update path — and, in hier mode, on the relay WAN hop only (the LAN
    # reduce stays exact) — plus chunked send pipelining
    compression: str = "none"  # none | qsgd[:block] | topk[:frac]
    # byte-domain wire codec on every backend channel (lossless, so it
    # rides all modes and both directions): none | zlib[:level]
    wire_codec: str = "none"
    chunk_mb: float = 0.0  # 0 = unchunked wires

    # fault & churn injection (fl/fault.py, core/netsim.LinkFaultModel)
    # availability trace spec: "" = no churn; "auto:UP/DOWN" = generated
    # exponential up/down periods; else explicit "client0:leave@T,join@T"
    availability_trace: str = ""
    link_loss_rate: float = 0.0  # per-chunk wire loss on every direct link
    region_quorum: float = 0.5  # hier: min live fraction per region
    relay_conns: int = 8  # hier: WAN-hop connection multiplexing per relay
    relay_depth: int = 1  # hier: relay-tree levels (1 = single-tier)

    # -- the one FLConfig <-> Scenario conversion ------------------------
    def to_scenario(self, *, tier: str = "small", local_steps: int = 4,
                    store_fail_rate: float = 0.0):
        """Lift this flat config into the declarative ``Scenario`` spec.

        This and its inverse, ``Scenario.fl_config()``, are THE two
        conversion points between the flat runtime config and the
        declarative spec — every entry point (``fl_train``, tests,
        examples) routes through them, so a field added to one side must
        be added to both or the round-trip tests fail. Implemented by
        ``Scenario.from_fl_config`` (the Scenario side owns the field
        mapping); ``tier`` / ``local_steps`` / ``store_fail_rate`` are
        deployment knobs with no FLConfig field."""
        from repro_torch.scenario import Scenario
        return Scenario.from_fl_config(self, tier=tier,
                                       local_steps=local_steps,
                                       store_fail_rate=store_fail_rate)
