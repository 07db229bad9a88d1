"""Port of ``src/repro/sharding/``: the logical-axis sharding plan."""
from repro_torch.sharding.rules import (MeshPlan, Sharder, batch_spec,
                                        bytes_of, constrain)

__all__ = ["MeshPlan", "Sharder", "batch_spec", "bytes_of", "constrain"]
