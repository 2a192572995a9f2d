"""VAE training on NMC background-error samples, on PyTorch.

Port of vaevar_tpu/train/vae_trainer.py, itself the reference
`vae_nmc_model.train` (model/model.py:571-659): per batch of 5 six-hourly
normalized frames, the error sample is

    err = (frame[4] - fengwu^4(frame[0])) / ERR_STD,  nearest-resized to the
    latent grid,

with the flow model run without gradients, and the VAE minimizes
recon / (2 sigma^2) + KLD with Adam (lr 1e-4, betas (0.9, 0.999), eps
1e-8: builder.make_optimizer's torch.optim.Adam computes optax.adam's
update). The VAE is an `nn.Module` on its device that the steps update in
place. The
reparameterization noise of step j of epoch e comes from a torch.Generator
seeded from (seed, e, j), so a resumed run replays the uninterrupted run's
trajectory; it is not the JAX package's `fold_in` draw, and a caller that
needs given noise passes `eps`. The JAX version's `mesh` (data-parallel
training) waits for ROADMAP A.13.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.models.vae import elbo_loss
from vaevar_tpu_torch.ops.interp import resize_nearest
from vaevar_tpu_torch.train.builder import make_optimizer


def nmc_error_sample(frames, fengwu, latent_hw, nmc_steps: int = 4):
    """frames: (B, >nmc_steps, C, H, W) normalized. Returns (B, C, *latent_hw)."""
    C = frames.shape[2]
    with torch.no_grad():
        pred = frames[:, 0]
        for _ in range(nmc_steps):
            pred = fengwu(pred)[:, :C]
    err_std = torch.as_tensor(channels.ERR_STD[:C], dtype=torch.float32,
                              device=frames.device).reshape(1, -1, 1, 1)
    err = (frames[:, nmc_steps] - pred) / err_std
    return resize_nearest(err, latent_hw)


def vae_loss(vae, err, sigma: float, generator=None, eps=None):
    """(total, reconstruction sse, kld) of one VAE pass over `err`."""
    recon, mu, logvar = vae(err, generator, eps)
    return elbo_loss(recon, err, mu, logvar, sigma)


def make_vae_train_step(vae, fengwu, sigma: float = 2.0, lr: float = 1e-4,
                        latent_hw=(128, 256), nmc_steps: int = 4):
    """-> (init_fn, train_step). `init_fn(params=None)` loads `params` (a VAE
    state_dict, strictly) when given and returns a fresh Adam over the VAE's
    parameters; `train_step(optimizer, frames, generator=None, eps=None)`
    takes one step in place and returns {"loss", "rec_sse", "kld"} as device
    scalars."""

    def init_fn(params=None):
        if params is not None:
            vae.load_state_dict(params, strict=True)
        return make_optimizer(vae.parameters(), "Adam", lr)

    def train_step(optimizer, frames, generator=None, eps=None):
        err = nmc_error_sample(frames, fengwu, latent_hw, nmc_steps)
        optimizer.zero_grad(set_to_none=True)
        total, sse, kld = vae_loss(vae, err, sigma, generator, eps)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "rec_sse": sse.detach(), "kld": kld.detach()}

    return init_fn, train_step


def step_generator(device, seed: int, *keys: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *keys)."""
    s = int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def _check_batch(batch, vae, nmc_steps):
    """The one-batch probe: the shapes the step will take, checked before
    the first step (the JAX package sizes its parameters from it)."""
    cfg = vae.enc.cfg
    want_c = sum(cfg.inchans_list)
    if batch.ndim != 5 or batch.shape[1] <= nmc_steps or batch.shape[2] != want_c:
        raise ValueError(f"training batch of shape {tuple(batch.shape)}: want (B, L > "
                         f"{nmc_steps}, {want_c}, H, W) for nmc_steps {nmc_steps}")


def train_vae(
    vae,
    fengwu,
    data_iter: Iterable | Callable,
    epochs: int = 1,
    sigma: float = 2.0,
    lr: float = 1e-4,
    latent_hw=(128, 256),
    nmc_steps: int = 4,
    seed: int = 0,
    log_every: int = 10,
    logger=print,
    ckpt_dir: str | None = None,
    resume: bool = True,
    init_params=None,
):
    """Full training loop over host batches, on the VAE's device; returns
    (vae, per-step metrics of this run).

    `data_iter` is a plain iterable (reused every epoch) or a factory
    `epoch -> iterable` for per-epoch reshuffling. With `init_params` (a VAE
    state_dict) the VAE is warm-started from it; otherwise one batch of
    epoch 0 is probed for its shapes, and the probe's iterator is closed.
    With `ckpt_dir`, {VAE, Adam state} is saved at every epoch end as
    checkpoint_latest (after checkpoint_best when the epoch's mean loss
    improves), and training resumes from checkpoint_latest when one exists."""
    from vaevar_tpu_torch.train import checkpoint as ckpt

    init_fn, train_step = make_vae_train_step(vae, fengwu, sigma, lr, latent_hw, nmc_steps)
    device = next(vae.parameters()).device
    factory = data_iter if callable(data_iter) else (lambda _e: data_iter)

    if init_params is None:
        probe = iter(factory(0))
        try:
            first = next(probe, None)
        finally:
            # stop a prefetched() worker at once: the probe needs one batch
            if hasattr(probe, "close"):
                probe.close()
        if first is None:
            raise ValueError("empty training loader: no batch to size init")
        _check_batch(np.asarray(first), vae, nmc_steps)
    optimizer = init_fn(init_params)

    start_epoch, metric_best = 0, float("inf")
    if ckpt_dir and resume:
        got = ckpt.restore_train_state(ckpt_dir, {"model": vae}, optimizer)
        if got is not None:
            meta = got[2]
            start_epoch = int(meta.get("epoch", -1)) + 1
            metric_best = float(meta.get("metric_best", float("inf")))
            logger(f"resumed from {ckpt_dir}/checkpoint_latest at epoch {start_epoch}")

    history = []
    for epoch in range(start_epoch, epochs):
        vae.train()
        epoch_losses = []
        for j, batch in enumerate(factory(epoch)):
            frames = torch.as_tensor(np.asarray(batch), dtype=torch.float32).to(device)
            m = train_step(optimizer, frames, step_generator(device, seed, epoch, j))
            rec = {k: float(v) for k, v in m.items()}
            if (j + 1) % log_every == 0:
                logger(f"epoch {epoch} iter {j} loss {rec['loss']:.3f} "
                       f"rec {rec['rec_sse']:.3f} kld {rec['kld']:.3f}")
            history.append(rec)
            epoch_losses.append(rec["loss"])
        # prior sample sanity check (model/model.py:648-653)
        vae.eval()
        z = torch.randn((1, sum(vae.dec.cfg.inchans_list), *latent_hw),
                        generator=step_generator(device, seed, 10_000 + epoch), device=device)
        with torch.no_grad():
            y = vae.decoder(z)
        logger(f"epoch {epoch} prior-sample std {float(y.float().std(correction=0)):.3f}")
        if ckpt_dir:
            epoch_mean = float(np.mean(epoch_losses)) if epoch_losses else float("inf")
            if epoch_mean < metric_best:
                metric_best = epoch_mean
                ckpt.save_train_state(ckpt_dir, {"model": vae}, optimizer, epoch,
                                      metric_best=metric_best, alias="checkpoint_best")
            ckpt.save_train_state(ckpt_dir, {"model": vae}, optimizer, epoch,
                                  metric_best=metric_best, alias="checkpoint_latest")
    return vae, history


def replicated_checksum(model) -> float:
    """Sum of |parameter| over the model (utils/misc.py:408-420's
    check_ddp_consistency as one scalar to compare across processes)."""
    with torch.no_grad():
        return float(sum(p.detach().float().abs().sum() for p in model.parameters()))
