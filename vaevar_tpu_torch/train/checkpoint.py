"""Checkpoint save/restore for training state, in torch's format.

Port of vaevar_tpu/train/checkpoint.py:17-93. A checkpoint is one
`torch.save` file (the JAX package writes an orbax directory) with the same
`<path>.meta.json` sidecar for the scalars: {epoch, step, metric_best}. In a
data-parallel run only rank 0 writes, and a barrier follows the write.
Files are loaded with `weights_only=True`, so a checkpoint holds tensors and
plain containers only.

Model weights are a bare state_dict under the reference torch key names:
`run_train_forecast` writes one as `params_latest`, and the converters
write them from a reference `.pth` (`vaevar_tpu_torch/convert_ckpt.py`) or
from the JAX package's orbax trees (`scripts/orbax_to_torch.py`, which runs
where jax is). `load_weights` reads one into a model strictly.
"""

from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist

from vaevar_tpu_torch.parallel import mesh


def _on_rank0(write) -> None:
    """write() on rank 0 only (the JAX trainers' rank-0 save); in a
    data-parallel run every rank then waits at a barrier, so no rank reads a
    file before it is there."""
    if mesh.process_index() == 0:
        write()
    if dist.is_initialized():
        dist.barrier()


def save(path: str, tree) -> None:
    """torch.save `tree` to `path`, replacing any older file atomically; in
    a data-parallel run rank 0 writes and the others wait for it."""
    path = os.path.abspath(path)

    def write():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)

    _on_rank0(write)


def restore(path: str, map_location="cpu"):
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


def exists(path: str) -> bool:
    return os.path.isfile(path)


# --- full training state (params + optimizer + progress) --------------------
#
# The reference's checkpoint dicts (model/model.py:313-382): {model,
# optimizer, epoch, metric_best}, written as checkpoint_latest and, when the
# validation metric improves, checkpoint_best.


def _optimizer_parts(opt_state):
    """(optimizer, scheduler or None) of an OptState or a bare optimizer."""
    if isinstance(opt_state, torch.optim.Optimizer):
        return opt_state, None
    return opt_state.optimizer, opt_state.scheduler


def save_train_state(out_dir: str, trainable, opt_state, epoch: int, step: int = 0,
                     metric_best: float | None = None,
                     alias: str = "checkpoint_latest") -> str:
    """Write the trainable ({"model": nn.Module, and any tensors such as
    logvar bounds}) and the optimizer state (forecast_trainer.OptState, or
    an optimizer without a scheduler) under out_dir/alias. In a
    data-parallel run every rank calls this; rank 0 writes, and the others
    wait at a barrier until it has."""
    path = os.path.join(os.path.abspath(out_dir), alias)
    params = {k: (v.state_dict() if isinstance(v, torch.nn.Module) else v.detach())
              for k, v in trainable.items()}
    optimizer, scheduler = _optimizer_parts(opt_state)
    state = {"optimizer": optimizer.state_dict()}
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    meta = {"epoch": int(epoch), "step": int(step)}
    if metric_best is not None:
        meta["metric_best"] = float(metric_best)

    def write_meta():
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    save(path, {"params": params, "opt_state": state})
    _on_rank0(write_meta)
    return path


def restore_train_state(out_dir: str, trainable, opt_state,
                        alias: str = "checkpoint_latest"):
    """Load out_dir/alias into `trainable` and `opt_state` in place; returns
    (trainable, opt_state, meta) or None if there is no checkpoint. In a
    data-parallel run every rank restores the same file."""
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
    optimizer, scheduler = _optimizer_parts(opt_state)
    optimizer.load_state_dict(tree["opt_state"]["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(tree["opt_state"]["scheduler"])
    meta = {"epoch": 0, "step": 0}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta.update(json.load(f))
    return trainable, opt_state, meta


# --- model weights ------------------------------------------------------------


def reference_state_dict(obj) -> dict:
    """Normalize a loaded reference ``.pth`` object to a flat state_dict.

    Mirrors the reference's own loading quirks (da_4dvar.py:552-603):
    training checkpoints wrap the weights as ``{"model": sd}`` (flow,
    :576) or ``{"model": {"lgunet_all": sd}}`` (forecast, :557) while VAE
    files are bare state_dicts (:592); DDP-saved trees carry a
    ``module.`` key prefix (stripped, :560-562,579-581,595-597); the
    trainer's ``max_logvar``/``min_logvar`` buffers are dropped
    (:564,583,599)."""
    sd = obj
    for key in ("model", "lgunet_all"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k in ("max_logvar", "min_logvar"):
            continue
        out[k] = v
    return out


def vae_decoder_params(sd: dict) -> dict:
    """The decoder's state_dict from a VAE checkpoint (port of
    vaevar_tpu/train/checkpoint.py:95-107): a full VAE state_dict
    (`enc.`/`dec.`-prefixed LGUnets, what the VAE converters write and the
    reference's whole `VAE_lr` files hold) gives its `dec.` entries without
    the prefix; a decoder-only state_dict passes through. The DA engine only
    runs the decoder (da_4dvar.py:1186)."""
    if any(k.startswith(("enc.net.", "dec.net.")) for k in sd):
        return {k[len("dec."):]: v for k, v in sd.items() if k.startswith("dec.")}
    return sd


def load_weights(model: torch.nn.Module, path: str, vae: bool = False) -> torch.nn.Module:
    """Load model weights from `path` into `model` with strict=True, so a
    checkpoint of another architecture fails loudly. Reads a port checkpoint
    or a reference `.pth` that holds only tensors (its wrappers, `module.`
    prefixes and logvar buffers go, as `reference_state_dict` says); with
    `vae`, a full VAE file gives its decoder. The file is read onto the CPU;
    move the model to its device afterwards."""
    sd = reference_state_dict(restore(path))
    if vae:
        sd = vae_decoder_params(sd)
    model.load_state_dict(sd, strict=True)
    return model
