"""Checkpoint save/restore for training state, in torch's format.

Port of vaevar_tpu/train/checkpoint.py:17-93. A checkpoint is one
`torch.save` file (the JAX package writes an orbax directory) with the same
`<path>.meta.json` sidecar for the scalars: {epoch, step, metric_best}.
Files are loaded with `weights_only=True`, so a checkpoint holds tensors and
plain containers only. Reading the JAX package's orbax checkpoints, and
`vae_decoder_params`, wait for ROADMAP A.12.
"""

from __future__ import annotations

import json
import os

import torch


def save(path: str, tree) -> None:
    """torch.save `tree` to `path`, replacing any older file atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore(path: str, map_location="cpu"):
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


def exists(path: str) -> bool:
    return os.path.isfile(path)


# --- full training state (params + optimizer + progress) --------------------
#
# The reference's checkpoint dicts (model/model.py:313-382): {model,
# optimizer, epoch, metric_best}, written as checkpoint_latest and, when the
# validation metric improves, checkpoint_best.


def save_train_state(out_dir: str, trainable, opt_state, epoch: int, step: int = 0,
                     metric_best: float | None = None,
                     alias: str = "checkpoint_latest") -> str:
    """Write the trainable ({"model": nn.Module, logvar bounds}) and the
    optimizer state (forecast_trainer.OptState) under out_dir/alias."""
    path = os.path.join(os.path.abspath(out_dir), alias)
    params = {k: (v.state_dict() if isinstance(v, torch.nn.Module) else v.detach())
              for k, v in trainable.items()}
    save(path, {"params": params,
                "opt_state": {"optimizer": opt_state.optimizer.state_dict(),
                              "scheduler": opt_state.scheduler.state_dict()}})
    meta = {"epoch": int(epoch), "step": int(step)}
    if metric_best is not None:
        meta["metric_best"] = float(metric_best)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def restore_train_state(out_dir: str, trainable, opt_state,
                        alias: str = "checkpoint_latest"):
    """Load out_dir/alias into `trainable` and `opt_state` in place; returns
    (trainable, opt_state, meta) or None if there is no checkpoint."""
    path = os.path.join(os.path.abspath(out_dir), alias)
    if not exists(path):
        return None
    tree = restore(path)
    with torch.no_grad():
        for k, v in tree["params"].items():
            if isinstance(trainable[k], torch.nn.Module):
                trainable[k].load_state_dict(v)
            else:
                trainable[k].copy_(v)
    opt_state.optimizer.load_state_dict(tree["opt_state"]["optimizer"])
    opt_state.scheduler.load_state_dict(tree["opt_state"]["scheduler"])
    meta = {"epoch": 0, "step": 0}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta.update(json.load(f))
    return trainable, opt_state, meta
