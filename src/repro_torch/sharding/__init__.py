"""Port of ``src/repro/sharding/``: the logical-axis sharding plan and
its placements on a ``DeviceMesh``."""
from repro_torch.sharding.rules import (MeshPlan, Sharder, Sharding,
                                        batch_spec, bytes_of, constrain,
                                        gather, gather_tree, place,
                                        place_tree, placements)

__all__ = ["MeshPlan", "Sharder", "Sharding", "batch_spec", "bytes_of",
           "constrain", "gather", "gather_tree", "place", "place_tree",
           "placements"]
