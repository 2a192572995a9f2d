"""Random parameters in seconds for smoke runs and benchmarks.

Every parameter of a module is filled with N(0, scale^2) draws from a numpy
generator seeded with `seed`, in `named_parameters` order (the analogue of
vaevar_tpu/utils/fast_init.py, which fills the flax tree the same way). Not
for training: use a trained checkpoint when the weights matter.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def fast_init(model: torch.nn.Module, seed: int = 0, scale: float = 0.02):
    rng = np.random.default_rng(seed)
    for _, p in model.named_parameters():
        a = rng.standard_normal(p.shape, dtype=np.float32)
        a *= np.float32(scale)
        p.copy_(torch.from_numpy(a))
    return model
