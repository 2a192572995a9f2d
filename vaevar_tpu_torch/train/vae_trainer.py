"""VAE training on NMC background-error samples, on PyTorch.

Port of vaevar_tpu/train/vae_trainer.py, itself the reference
`vae_nmc_model.train` (model/model.py:571-659): per batch of 5 six-hourly
normalized frames, the error sample is

    err = (frame[4] - fengwu^4(frame[0])) / err_std,  nearest-resized to the
    latent grid,

with the flow model run without gradients, and the VAE minimizes
recon / (2 sigma^2) + KLD with Adam (lr 1e-4, betas (0.9, 0.999), eps
1e-8: builder.make_optimizer's torch.optim.Adam computes optax.adam's
update). The VAE is an `nn.Module` on its device that the steps update in
place. The
reparameterization noise of step j of epoch e is the JAX trainer's draw,
jax.random.normal(fold_in(fold_in(PRNGKey(seed), e), j)), computed on the
VAE's device by utils/jax_random.py: a resumed run replays the uninterrupted
run's trajectory, and the port replays a JAX run's noise on any device.
`err_std` replaces ERR_STD where a run has its own error scale (the OSSE's
empirical 24 h error std).

Data parallelism (`mesh`, parallel/mesh.py) is the reference's DDP: the VAE
is wrapped in DistributedDataParallel, the flow model stays a replicated
module without gradients, and every rank draws its own rows of the GLOBAL
batch's noise (the counter-based draw computes just those rows), as the
JAX trainer's dp axis shards one draw, so a dp=N run computes what a dp=1
run computes on the global batch (the ranks' local batches in rank order). The ELBO is a sum over the batch, and DDP averages gradients, so
each rank's loss is scaled by N before the backward: the all-reduced
gradient is then the global sum's, as the JAX package's. Losses are logged
as global sums, and the ranks' parameter checksums must agree bit for bit at
every epoch end.

The spatial mesh (`--mesh DPxSHxSW`, a parallel/mesh.TrainMesh,
docs/SPATIAL_TRAINING.md) partitions both models (`LGUnet.partition`):
each rank holds its dp rows' (lat, lon) tile of the frames and of every
activation, rolls FLOW_140 out on it, and draws its rows and its tile of
the global noise. The ELBO is a sum over the batch and the grid, so the
ranks' partial sums add up to the global loss, and the parameter gradients
are summed over all DP x SH x SW ranks before Adam by manual all-reduces
after the backward (`pmesh.all_sum_grads`), not DDP: DDP averages, and its
bucketed all-reduces would run beside the halo exchanges on other groups.
Every rank receives the same sum, so the replicas stay bitwise equal.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.models.vae import elbo_loss
from vaevar_tpu_torch.ops.interp import resize_nearest
from vaevar_tpu_torch.parallel import mesh as pmesh
from vaevar_tpu_torch.train.builder import make_optimizer
from vaevar_tpu_torch.utils import jax_random


def nmc_error_sample(frames, fengwu, latent_hw, nmc_steps: int = 4, err_std=None,
                     tiling=None):
    """frames: (B, >nmc_steps, C, H, W) normalized. Returns (B, C, *latent_hw).
    `err_std` (C,) defaults to channels.ERR_STD[:C]. With a `tiling`
    (parallel/spatial.py) frames and fengwu are partitioned: frames is this
    rank's tile of the grid and the result its tile of the latent grid."""
    C = frames.shape[2]
    with torch.no_grad():
        pred = frames[:, 0]
        for _ in range(nmc_steps):
            pred = fengwu(pred)[:, :C]
    if err_std is None:
        err_std = channels.ERR_STD[:C]
    err_std = torch.as_tensor(np.asarray(err_std), dtype=torch.float32,
                              device=frames.device).reshape(1, -1, 1, 1)
    err = (frames[:, nmc_steps] - pred) / err_std
    if tiling is None:
        return resize_nearest(err, latent_hw)
    if (err.shape[-2] * tiling.sh, err.shape[-1] * tiling.sw) == tuple(latent_hw):
        return err  # the identity resize of the whole field: its tile is this tile
    rows, cols = tiling.tile(latent_hw, "the latent grid")
    return resize_nearest(tiling.gather(err), latent_hw, pmesh.Tile(rows, cols, True))


def vae_loss(vae, err, sigma: float, eps=None):
    """(total, reconstruction sse, kld) of one VAE pass over `err` with the
    reparameterization noise `eps` (torch's default generator when None)."""
    recon, mu, logvar = vae(err, eps=eps)
    return elbo_loss(recon, err, mu, logvar, sigma)


def make_vae_train_step(vae, fengwu, sigma: float = 2.0, lr: float = 1e-4,
                        latent_hw=(128, 256), nmc_steps: int = 4, err_std=None, mesh=None):
    """-> (init_fn, train_step). `init_fn(params=None)` loads `params` (a VAE
    state_dict, strictly) when given and returns a fresh Adam over the VAE's
    parameters; `train_step(optimizer, frames, eps=None)` takes one step in
    place and returns {"loss", "rec_sse", "kld"} as device scalars; `eps`
    is the reparameterization noise of `frames` (torch's default generator
    draws it when None). With a distributed `mesh` the VAE runs under DDP,
    `frames` and `eps` are this rank's rows of the global batch, and the
    metrics are global sums. With a TrainMesh the VAE and fengwu are
    partitioned here, `frames` and `eps` are also this rank's (lat, lon)
    tiles, and the gradients are summed over the world (module docstring)."""
    model, world = vae, 1
    tiling = mesh.tiling if isinstance(mesh, pmesh.TrainMesh) else None
    if tiling is not None:
        vae.partition(tiling)
        fengwu.partition(tiling)
        world = pmesh.process_count()
    elif mesh is not None and mesh.distributed:
        from torch.nn.parallel import DistributedDataParallel

        dev = next(vae.parameters()).device
        model = DistributedDataParallel(vae, device_ids=[dev] if dev.type == "cuda" else None)
        world = pmesh.process_count()

    def init_fn(params=None):
        if params is not None:
            vae.load_state_dict(params, strict=True)
        return make_optimizer(vae.parameters(), "Adam", lr)

    def train_step(optimizer, frames, eps=None):
        err = nmc_error_sample(frames, fengwu, latent_hw, nmc_steps, err_std, tiling)
        optimizer.zero_grad(set_to_none=True)
        if eps is not None:
            eps = eps.to(err.device)
        total, sse, kld = vae_loss(model, err, sigma, eps=eps)
        if tiling is not None:  # this rank's share of the global gradient, summed
            total.backward()
            pmesh.all_sum_grads(vae.parameters())
        else:  # DDP averages gradients over the ranks; the ELBO sums over the batch
            (total * world if world > 1 else total).backward()
        optimizer.step()
        m = torch.stack([total.detach(), sse.detach(), kld.detach()])
        if world > 1:
            m = pmesh.all_sum(m)
        return dict(zip(("loss", "rec_sse", "kld"), m))

    return init_fn, train_step


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
    sample_at_epoch_end: bool = True,
    mesh=None,
    ckpt_dir: str | None = None,
    resume: bool = True,
    init_params=None,
    err_std=None,
):
    """Full training loop over host batches, on the VAE's device; returns
    (vae, per-step metrics of this run).

    `data_iter` is a plain iterable (reused every epoch) or a factory
    `epoch -> iterable` for per-epoch reshuffling. With `init_params` (a VAE state_dict) the VAE is
    warm-started from it; otherwise one batch of epoch 0 is probed for its
    shapes, and the probe's iterator is closed. With `sample_at_epoch_end`
    each epoch ends with a prior sample's std in the log. With a
    distributed `mesh` (parallel/mesh.DPMesh) each batch is this rank's
    local batch and the VAE trains under DDP (see the module docstring);
    with a TrainMesh each batch is this rank's dp rows, whole, of which it
    takes its (lat, lon) tile, and both models run partitioned.
    With `ckpt_dir`, {VAE, Adam state} is saved at every epoch end as
    checkpoint_latest (after checkpoint_best when the epoch's mean loss
    improves; rank 0 writes), and training resumes from checkpoint_latest
    when one exists (every rank reads it)."""
    from vaevar_tpu_torch.train import checkpoint as ckpt

    init_fn, train_step = make_vae_train_step(vae, fengwu, sigma, lr, latent_hw, nmc_steps,
                                              err_std, mesh)
    device = next(vae.parameters()).device
    factory = data_iter if callable(data_iter) else (lambda _e: data_iter)
    key, latent_c = jax_random.prng_key(seed), sum(vae.dec.cfg.inchans_list)
    world, rank = (pmesh.process_count(), pmesh.process_index()) if mesh is not None else (1, 0)
    tiling = mesh.tiling if isinstance(mesh, pmesh.TrainMesh) else None
    # the noise's tile of the latent grid and this rank's rows of the batch
    latent_tile = None if tiling is None else tiling.tile(latent_hw, "the latent grid")
    rows_of = ((lambda b: (rank * b, (rank + 1) * b)) if tiling is None else mesh.batch_spec)
    n_dp = world if tiling is None else mesh.dp

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
            batch = np.asarray(batch)
            if tiling is not None:
                rows, cols = tiling.tile(batch.shape[-2:], "the frames")
                batch = batch[..., rows, cols]
            frames = torch.as_tensor(batch, dtype=torch.float32).to(device)
            b = frames.shape[0]
            eps = jax_random.normal(jax_random.fold_in(jax_random.fold_in(key, epoch), j),
                                    (n_dp * b, latent_c, *latent_hw), device,
                                    rows=rows_of(b), tile=latent_tile)
            m = train_step(optimizer, frames, eps)
            rec = {k: float(v) for k, v in m.items()}
            if (j + 1) % log_every == 0:
                logger(f"epoch {epoch} iter {j} loss {rec['loss']:.3f} "
                       f"rec {rec['rec_sse']:.3f} kld {rec['kld']:.3f}")
            history.append(rec)
            epoch_losses.append(rec["loss"])
        if sample_at_epoch_end:
            # prior sample sanity check (model/model.py:648-653)
            vae.eval()
            z = jax_random.normal(jax_random.fold_in(key, 10_000 + epoch),
                                  (1, latent_c, *latent_hw), device, tile=latent_tile)
            with torch.no_grad():
                y = vae.decoder(z)
            if tiling is not None:
                y = tiling.gather(y)
            logger(f"epoch {epoch} prior-sample std {float(y.float().std(correction=0)):.3f}")
        if mesh is not None:
            pmesh.check_replicas(replicated_checksum(vae))
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
