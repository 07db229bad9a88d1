"""Seeded silo data: Dirichlet-skewed labels over the silos, images made
of Gaussian noise plus a class-dependent low-frequency pattern, so that
local training learns something. The same law as the port's
``make_silo_datasets``, drawn in one float32 call per silo."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import SiloDataset


def silo_datasets(n_silos: int, *, examples: int, num_classes: int,
                  image_size: int, seed: int, alpha: float = 0.5):
    rng = np.random.default_rng(seed)
    proportions = rng.dirichlet([alpha] * num_classes, size=n_silos)
    xs = np.linspace(0, np.pi * 2, image_size, dtype=np.float32)
    # the pattern of class k depends on k % 4 only
    grid = np.stack([np.sin(np.outer(xs * (k + 1), xs)) for k in range(4)])
    silos = []
    for sid in range(n_silos):
        labels = rng.choice(num_classes, size=examples,
                            p=proportions[sid]).astype(np.int32)
        feats = rng.standard_normal((examples, image_size, image_size, 3),
                                    dtype=np.float32)
        feats *= 0.3
        feats += grid[labels % 4][..., None]
        silos.append(SiloDataset(sid, "image", feats, labels, num_classes))
    return silos
