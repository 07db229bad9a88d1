"""Port of ``src/repro/core/__init__.py``.

The paper's primary contribution: pluggable cross-silo FL communication
backends (MPI_GENERIC / MPI_MEM_BUFF / gRPC / TensorRPC / gRPC+S3 / AUTO)
over a Table-I-calibrated network model + object store."""
from repro_torch.core.backends import BACKEND_NAMES, make_backend
from repro_torch.core.message import (FLMessage, PackedPayload,
                                      TensorPayload, VirtualPayload)
from repro_torch.core.netsim import ENVIRONMENTS, Environment
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.transport import Fabric, MemoryMeter

__all__ = ["make_backend", "BACKEND_NAMES", "FLMessage", "TensorPayload",
           "VirtualPayload", "PackedPayload", "Environment",
           "ENVIRONMENTS", "ObjectStore", "Fabric", "MemoryMeter"]
