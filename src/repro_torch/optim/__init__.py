"""Port of ``src/repro/optim/``: AdamW, SGD and the LR schedule."""
from repro_torch.optim.optimizers import (OptState, adamw_init, adamw_update,
                                          clip_by_global_norm, make_optimizer,
                                          sgd_init, sgd_update)
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["OptState", "adamw_init", "adamw_update", "sgd_init",
           "sgd_update", "make_optimizer", "clip_by_global_norm",
           "cosine_warmup"]
