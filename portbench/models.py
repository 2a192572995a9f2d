"""The two sides' models, built from a configuration file's model entry.

`program_model` builds the port's LGUnet (the system under test) as its
CLIs do, without torch's default initialisation, on the device; the
reference's `reference_model` is the plain float32 LGUnet of reference/.
Both take their weights from weights.draw with the same seed and role, so
they hold the same values.
"""

from __future__ import annotations

import torch

import weights
from reference import lgunet as ref_lgunet

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def program_config(entry: dict):
    from vaevar_tpu_torch.config import LGUnetConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in entry.items()}
    kw["dtype"] = _DTYPES[entry.get("dtype", "float32")]
    return LGUnetConfig(**kw)


def program_model(entry: dict, seed: int, role: str, device, **overrides):
    from vaevar_tpu_torch.models.init import without_default_init
    from vaevar_tpu_torch.models.lgunet import LGUnet

    cfg = program_config(entry).replace(**overrides)
    with without_default_init(), torch.device(device):
        model = LGUnet(cfg)
    return weights.draw(model.to(device), seed, role)


def reference_model(entry: dict, seed: int, role: str, device):
    ref_lgunet.strict_float32()
    with torch.device(device):
        model = ref_lgunet.LGUnet(entry)
    return weights.draw(model, seed, role)
