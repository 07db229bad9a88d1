"""Port of ``src/repro/scenario/__init__.py`` (copied; imports re-pointed).

Declarative scenario API: topology-as-a-graph, one spec from CLI to
fabric (see spec.py for the schema, build.py for the runtime)."""
from repro_torch.core.transport import FabricSpec
from repro_torch.scenario.build import Runtime, build_runtime, fault_model_for
from repro_torch.scenario.spec import (MODES, TOPOLOGY_PRESETS, BlackoutSpec,
                                 ChannelSpec, EdgeSpec, FaultSpec,
                                 FleetSpec, JobSpec, MultiScenario,
                                 Scenario, ScenarioError, SplitSpec,
                                 StrategySpec, TopologySpec,
                                 load_blackouts_file, with_overrides)

__all__ = ["Scenario", "TopologySpec", "FleetSpec", "ChannelSpec",
           "FaultSpec", "StrategySpec", "SplitSpec", "EdgeSpec",
           "BlackoutSpec", "FabricSpec", "JobSpec", "MultiScenario",
           "ScenarioError", "TOPOLOGY_PRESETS", "MODES", "with_overrides",
           "load_blackouts_file", "Runtime", "build_runtime",
           "fault_model_for"]
