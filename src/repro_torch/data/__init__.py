"""Port of ``src/repro/data/__init__.py`` (copied; imports re-pointed)."""
from repro_torch.data.synthetic import (SiloDataset, lm_batch_iterator,
                                  make_silo_datasets, synthetic_lm_batch)

__all__ = ["SiloDataset", "make_silo_datasets", "lm_batch_iterator",
           "synthetic_lm_batch"]
