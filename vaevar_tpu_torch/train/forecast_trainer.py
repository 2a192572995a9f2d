"""Supervised forecast-model training (LpLoss / Possloss) on PyTorch.

Port of vaevar_tpu/train/forecast_trainer.py, itself the reference
`basemodel` trainer (model/model.py:26-514):

- Possloss: Gaussian NLL over the (mean, logvar) output halves with
  learnable soft-clamped logvar bounds; LpLoss: relative L2;
- one- or two-step training (the second step feeds the mean back);
- `calculate_q`: per-pixel one-step error variance, the Q-matrix estimate
  the DA engine reads; `multi_step_predict`: the rollout evaluation.

The trainable is the dict `{"model", "max_logvar", "min_logvar"}` of the JAX
package, with the model as an `nn.Module` that holds its parameters; steps
update it in place and return it. The optimizer is optax's
`adamw(cosine_decay_schedule(lr, total_steps), b1=0.9, b2=0.9)`, written
with torch: AdamW with eps 1e-8 and weight decay 1e-4 on every parameter
(biases, norms and both logvar bounds), and the cosine decay in closed form
through `LambdaLR`, stepped after each update so that update k uses the
rate at count k, as optax counts.

Data parallelism (`mesh`, parallel/mesh.py) is the reference's DDP
(training_options.yaml:7): the objective, the model with both logvar bounds
(which live outside the model), runs under DistributedDataParallel, so one
all-reduce averages every gradient, the bounds' included; each rank's loss
is its local batch's mean, so the average is the global batch's gradient, as
the JAX package's dp axis computes it. Validation all-gathers pred and
target, so every rank computes the same metrics and keeps the same
checkpoint_best; the ranks' checksums (model and bounds) must agree bit for
bit at every epoch end.

The spatial mesh (`mesh` a parallel/mesh.TrainMesh, `--mesh DPxSHxSW`,
docs/SPATIAL_TRAINING.md) partitions the model (`LGUnet.partition`): each
rank holds its dp rows' (lat, lon) tile of the frames and of every
activation, and its loss is its exact share of the global one (`_Share`):
Possloss's sums over its tile divided by the global field and batch, the
logvar bounds' tile taken from the whole parameters, their 0.01 term added
on rank 0 alone; LpLoss's squared norms summed over the spatial group before
the square root (`sum_over_ranks`, whose backward hands each rank the
gradient of its own partial sum). The gradients, the bounds' included, are
summed over the world before AdamW (`pmesh.all_sum_grads`, not DDP), so
the step is the global one and every rank receives the same sum.
Validation gathers pred and target over the spatial group and the dp group
before the recorder.
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.parallel import mesh as pmesh


class _Share(NamedTuple):
    """A rank's part of the global loss on a TrainMesh: its (rows, cols)
    tile of the global output grid `hw`, the global batch, whether it adds
    the logvar bounds' term (rank 0 of the world, once), and its spatial
    group (None: the world)."""

    tile: tuple
    hw: tuple
    batch: int
    bounds: bool
    group: object


def lp_loss(pred, target, share: _Share | None = None):
    """Relative L2 per sample, averaged over the batch. With a `share` pred
    and target are a rank's tile: the squared norms are summed over the
    spatial group first, and the value is its dp rows' sum over the global
    batch (the same on every rank of the group)."""
    B = pred.shape[0]
    if share is not None:
        sq = torch.stack([((pred - target) ** 2).reshape(B, -1).sum(1),
                          (target ** 2).reshape(B, -1).sum(1)])
        d2, n2 = pmesh.sum_over_ranks(sq, share.group)
        return (d2.sqrt() / n2.sqrt()).sum() / share.batch
    d = torch.linalg.vector_norm(pred.reshape(B, -1) - target.reshape(B, -1), dim=1)
    n = torch.linalg.vector_norm(target.reshape(B, -1), dim=1)
    return (d / n).mean()


def poss_loss(pred, target, max_logvar, min_logvar, inc_var_loss: bool = True,
              share: _Share | None = None):
    """Gaussian NLL with clamped logvar; pred has 2x target channels. With
    a `share` pred and target are a rank's tile and this is its part of
    the global loss (`_Share`)."""
    mean, logvar = torch.chunk(pred, 2, dim=1)
    if share is not None:
        return _poss_share(mean, logvar, target, max_logvar, min_logvar, inc_var_loss, share)
    B = pred.shape[0]
    lv = logvar.reshape(B, -1)
    lv = max_logvar - torch.nn.functional.softplus(max_logvar - lv)
    lv = min_logvar + torch.nn.functional.softplus(lv - min_logvar)
    lv = lv.reshape(target.shape)
    if inc_var_loss:
        total = ((mean - target) ** 2 * torch.exp(-lv)).mean(dim=(-1, -2, -3)) \
            + lv.mean(dim=(-1, -2, -3))
    else:
        total = ((mean - target) ** 2).mean(dim=(-1, -2, -3))
    total = total + 0.01 * max_logvar.mean() - 0.01 * min_logvar.mean()
    return total.mean()


def _poss_share(mean, logvar, target, max_logvar, min_logvar, inc_var_loss, share):
    """A rank's part of Possloss: its tile's sums over the global field
    size and batch, the bounds (1, C H W) viewed as (1, C, H, W) and cut to
    the tile, and the bounds' term on one rank of the world."""
    C = target.shape[1]
    rows, cols = share.tile
    mx = max_logvar.view(1, C, *share.hw)[..., rows, cols]
    mn = min_logvar.view(1, C, *share.hw)[..., rows, cols]
    lv = mx - torch.nn.functional.softplus(mx - logvar)
    lv = mn + torch.nn.functional.softplus(lv - mn)
    if inc_var_loss:
        total = ((mean - target) ** 2 * torch.exp(-lv)).sum() + lv.sum()
    else:
        total = ((mean - target) ** 2).sum()
    total = total / (C * share.hw[0] * share.hw[1]) / share.batch
    if share.bounds:
        total = total + 0.01 * max_logvar.mean() - 0.01 * min_logvar.mean()
    return total


def cosine_decay(step: int, total_steps: int) -> float:
    """optax.cosine_decay_schedule's factor (alpha 0) at update `step`."""
    t = min(step, total_steps) / total_steps
    return 0.5 * (1.0 + math.cos(math.pi * t))


class OptState(NamedTuple):
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR


def _loss(trainable, inp, tars, loss_type, two_step, mesh=None):
    """(loss, first prediction) of the one- or two-step objective; on a
    TrainMesh inp, tars and the prediction are this rank's tiles and the
    loss its part of the global one (`_Share`)."""
    model = trainable["model"]
    nch = tars[0].shape[1]
    share = _share(mesh, model, inp.shape[0])

    def one(pred, tar):
        if loss_type == "Possloss":
            return poss_loss(pred, tar, trainable["max_logvar"], trainable["min_logvar"],
                             share=share)
        return lp_loss(pred[:, :tar.shape[1]], tar, share)

    pred = model(inp)
    loss = one(pred, tars[0])
    if two_step and len(tars) > 1:
        loss = loss + one(model(pred[:, :nch]), tars[1])
    return loss, pred


def _share(mesh, model, b: int):
    """This rank's `_Share` of the loss on a TrainMesh (`b` its local
    batch); None otherwise."""
    if not isinstance(mesh, pmesh.TrainMesh):
        return None
    tiling, hw = mesh.tiling, tuple(model.cfg.img_size)
    return _Share(tiling.tile(hw, "the output grid"), hw, b * mesh.dp, mesh.rank == 0,
                  mesh.group)


def _counted(loss, loss_type, mesh):
    """The part of a rank's loss that the global value sums: all of it but
    on a TrainMesh under LpLoss, where the first rank of each spatial group
    counts its dp rows' value and the others hold copies."""
    if isinstance(mesh, pmesh.TrainMesh) and loss_type != "Possloss":
        return loss * float(mesh.tiling.s == mesh.tiling.w == 0)
    return loss


def make_forecast_train_step(
    model: torch.nn.Module,
    loss_type: str = "Possloss",
    lr: float = 5e-6,
    total_steps: int = 10_000,
    two_step: bool = False,
    out_shape=None,  # (out_chans, H, W) needed for Possloss logvar bounds
    mesh=None,
):
    """-> (init_fn, train_step). `init_fn()` builds the trainable around
    `model` (on its device) and its optimizer state; `train_step(trainable,
    opt_state, inp, tars)` takes one AdamW step in place and returns
    (trainable, opt_state, loss). With a distributed `mesh` the step runs
    under DDP on this rank's local batch and the loss is the global batch's.
    With a TrainMesh the model is partitioned here (`LGUnet.partition`),
    `inp` and `tars` are this rank's dp rows' (lat, lon) tiles, the
    gradients are summed over the world before AdamW and the loss is the
    global one (module docstring)."""
    spatial = isinstance(mesh, pmesh.TrainMesh)
    if spatial:
        model.partition(mesh.tiling)

    objective = None  # the loss module (under DDP with a distributed data-parallel mesh)

    def init_fn():
        nonlocal objective
        trainable = {"model": model}
        if loss_type == "Possloss":
            c, h, w = out_shape
            n = c * h * w // 2
            dev = next(model.parameters()).device
            trainable["max_logvar"] = torch.nn.Parameter(torch.full((1, n), 0.5, device=dev))
            trainable["min_logvar"] = torch.nn.Parameter(torch.full((1, n), -10.0, device=dev))
        objective = _Objective(trainable, loss_type, two_step, mesh)
        if mesh is not None and mesh.distributed and not spatial:
            from torch.nn.parallel import DistributedDataParallel

            dev = next(model.parameters()).device
            objective = DistributedDataParallel(
                objective, device_ids=[dev] if dev.type == "cuda" else None)
        opt = torch.optim.AdamW(trainable_parameters(trainable), lr=lr, betas=(0.9, 0.9),
                                eps=1e-8, weight_decay=1e-4)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda s: cosine_decay(s, total_steps))
        return trainable, OptState(opt, sched)

    def train_step(trainable, opt_state, inp, tars):
        opt_state.optimizer.zero_grad(set_to_none=True)
        loss = objective(inp, tars)
        loss.backward()
        if spatial:  # this rank's share of the global gradient, summed
            pmesh.all_sum_grads(trainable_parameters(trainable))
        opt_state.optimizer.step()
        opt_state.scheduler.step()
        return trainable, opt_state, _global_mean(_counted(loss.detach(), loss_type, mesh), mesh)

    return init_fn, train_step


class _Objective(torch.nn.Module):
    """The training loss as one module over the model and the logvar bounds,
    so that DDP all-reduces the bounds' gradients with the model's."""

    def __init__(self, trainable, loss_type, two_step, mesh=None):
        super().__init__()
        self.model = trainable["model"]
        for k in ("max_logvar", "min_logvar"):
            if k in trainable:
                self.register_parameter(k, trainable[k])
        self.loss_type, self.two_step, self.mesh = loss_type, two_step, mesh

    def forward(self, inp, tars):
        trainable = {"model": self.model, **dict(self.named_parameters(recurse=False))}
        return _loss(trainable, inp, tars, self.loss_type, self.two_step, self.mesh)[0]


def trainable_parameters(trainable):
    """The model's parameters, then the logvar bounds when there are any."""
    return list(trainable["model"].parameters()) + [
        trainable[k] for k in ("max_logvar", "min_logvar") if k in trainable]


def trainable_checksum(trainable) -> float:
    """Sum of |value| over the model and the logvar bounds: the quantity the
    ranks of a data-parallel run compare (utils/misc.py:408-420)."""
    with torch.no_grad():
        return float(sum(p.detach().float().abs().sum() for p in trainable_parameters(trainable)))


def _global_mean(x, mesh):
    """The global batch's value of a per-rank loss: the mean over the ranks
    of a data-parallel run (equal local batches), the sum of the ranks'
    counted parts on a TrainMesh (`_counted`); x itself in one process."""
    if mesh is None or not mesh.distributed:
        return x
    if isinstance(mesh, pmesh.TrainMesh):
        return pmesh.all_sum(x)
    return pmesh.all_sum(x) / pmesh.process_count()


def make_eval_step(loss_type: str = "Possloss", two_step: bool = False, mesh=None):
    """Validation step (reference basemodel.test_one_step,
    model/model.py:235-257): the training loss plus the prediction's mean
    half, without gradients. On a TrainMesh (the model partitioned) the
    inputs and the prediction are this rank's tiles, and the loss is the
    part of the global one that `evaluate` sums (`_counted`)."""

    @torch.no_grad()
    def eval_step(trainable, inp, tars):
        loss, pred = _loss(trainable, inp, tars, loss_type, two_step, mesh)
        return _counted(loss, loss_type, mesh), pred[:, :tars[0].shape[1]]

    return eval_step


def _device_of(trainable):
    return next(trainable["model"].parameters()).device


def _put(batch, device):
    return torch.as_tensor(np.asarray(batch), dtype=torch.float32).to(device)


def evaluate(eval_step, trainable, val_iter: Iterable, recorder=None,
             data_std=None, mesh=None) -> dict:
    """Run the validation loop; returns mean scalars over batches (the
    reference's basemodel.test, model/model.py:414-431). `recorder` is a
    utils.metrics.MetricsRecorder, evaluated on the normalized fields with
    data_std scaling to physical units. With a distributed `mesh` each batch
    is this rank's local batch: the loss is averaged over the ranks, and pred
    and target are all-gathered into the global batch before the recorder
    sees them, so every rank computes the same numbers. On a TrainMesh each
    batch is this rank's dp rows, whole, of which it takes its (lat, lon)
    tile; the loss is the global one, and pred and target are gathered over
    the spatial group, then over the dp group (the JAX trainer's
    process_allgather)."""
    device = _device_of(trainable)
    dp = mesh is not None and mesh.distributed
    sums, n = {}, 0
    for inp, tars in val_iter:
        inp, tars = _tiles(inp, tars, mesh)
        tars_t = [_put(t, device) for t in tars]
        loss, pred = eval_step(trainable, _put(inp, device), tars_t)
        scalars = {"loss": float(_global_mean(loss, mesh))}
        if recorder is not None:
            gt = tars_t[0]
            if isinstance(mesh, pmesh.TrainMesh):
                pred, gt = (_gather_batch(mesh, mesh.tiling.gather(t)) for t in (pred, gt))
            elif dp:
                pred, gt = pmesh.global_batch(pred), pmesh.global_batch(gt)
            scalars.update(recorder.evaluate_batch({"pred": pred, "gt": gt, "std": data_std}))
        for k, v in scalars.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def _tiles(inp, tars, mesh):
    """This rank's (lat, lon) tiles of a batch of its dp rows on a
    TrainMesh; the batch itself otherwise."""
    if not isinstance(mesh, pmesh.TrainMesh):
        return inp, tars
    rows, cols = mesh.tiling.tile(np.shape(inp)[-2:], "the frames")
    return (np.asarray(inp)[..., rows, cols], [np.asarray(t)[..., rows, cols] for t in tars])


def _gather_batch(mesh, x):
    """The global batch of a TrainMesh's whole fields: every dp index's
    rows in order, all-gathered over this rank's dp group."""
    if mesh.dp == 1:
        return x
    return torch.cat([p.to(x.device) for p in pmesh._all_gather(x, mesh.dp_group)])


def train_forecast(
    model,
    train_factory,  # epoch -> iterable of (inp, [tar...]) normalized batches
    val_factory=None,  # () -> iterable for the held-out validation range
    epochs: int = 1,
    steps_per_epoch: int | None = None,
    loss_type: str = "Possloss",
    lr: float = 5e-6,
    two_step: bool = False,
    out_shape=None,
    ckpt_dir: str | None = None,
    resume: bool = True,
    save_best_param: str = "loss",
    recorder=None,
    data_std=None,
    logger=print,
    log_every: int = 10,
    mesh=None,
    writer=None,
):
    """Epoch-loop trainer with validation-driven best-checkpoint selection
    and full mid-run resume (the reference's basemodel.trainer,
    model/model.py:396-410, and save/load_checkpoint, :313-382), on the
    model's device. Returns (trainable, per-step losses of this run).

    Checkpoints carry {model and logvar bounds, optimizer and schedule
    state} with {epoch, step, metric_best} in a JSON sidecar;
    checkpoint_best is refreshed whenever the epoch's mean validation
    `save_best_param` improves, checkpoint_latest after every epoch.
    `writer` (a meters.ScalarWriter) logs the per-step train loss at the
    true global step on rank 0, so a resumed run continues the scalar
    stream. With a distributed `mesh` (parallel/mesh.DPMesh) each batch is
    this rank's local batch and the step runs under DDP (see the module
    docstring); with a TrainMesh each batch is this rank's dp rows, whole,
    of which it takes its (lat, lon) tile, and the model runs partitioned.
    Rank 0 writes the checkpoints and every rank resumes from them."""
    from vaevar_tpu_torch.train import checkpoint as ckpt

    total = (steps_per_epoch or 1000) * epochs
    init_fn, train_step = make_forecast_train_step(
        model, loss_type=loss_type, lr=lr, total_steps=total,
        two_step=two_step, out_shape=out_shape, mesh=mesh)
    trainable, opt_state = init_fn()
    eval_step = make_eval_step(loss_type, two_step, mesh)
    device = _device_of(trainable)

    start_epoch, start_step, metric_best = 0, 0, None
    if ckpt_dir and resume:
        got = ckpt.restore_train_state(ckpt_dir, trainable, opt_state)
        if got is not None:
            trainable, opt_state, meta = got
            start_epoch = int(meta.get("epoch", -1)) + 1
            start_step = int(meta.get("step", 0)) or start_epoch * (steps_per_epoch or 0)
            metric_best = meta.get("metric_best")
            logger(f"resumed at epoch {start_epoch} step {start_step} "
                   f"(metric_best={metric_best})")

    history = []
    gstep = start_step
    for epoch in range(start_epoch, epochs):
        model.train()
        for j, (inp, tars) in enumerate(train_factory(epoch)):
            if steps_per_epoch is not None and j >= steps_per_epoch:
                break
            inp, tars = _tiles(inp, tars, mesh)
            trainable, opt_state, loss = train_step(
                trainable, opt_state, _put(inp, device), [_put(t, device) for t in tars])
            loss = float(loss)
            if (j + 1) % log_every == 0:
                logger(f"epoch {epoch} iter {j} loss {loss:.4f}")
            history.append(loss)
            if writer is not None and pmesh.process_index() == 0:
                writer.add_scalar("loss", loss, gstep)
            gstep += 1
        val = {}
        if val_factory is not None:
            model.eval()
            val = evaluate(eval_step, trainable, val_factory(), recorder, data_std, mesh)
            shown = {k: v for k, v in val.items() if not k[-1].isdigit()}
            if writer is not None and pmesh.process_index() == 0:
                writer.add_scalars({f"val_{k}": v for k, v in shown.items()}, epoch)
            shown.update({  # the reference's channels of record
                k: val[k] for k in ("WRMSE11", "WRMSE66", "WRMSE2") if k in val})
            logger(f"epoch {epoch} val: " + " ".join(
                f"{k} {v:.4g}" for k, v in sorted(shown.items())))
        if mesh is not None:
            pmesh.check_replicas(trainable_checksum(trainable))
        if ckpt_dir:
            metric_now = val.get(save_best_param)
            if metric_now is not None and (metric_best is None or metric_now < metric_best):
                metric_best = metric_now
                ckpt.save_train_state(ckpt_dir, trainable, opt_state, epoch, step=gstep,
                                      metric_best=metric_best, alias="checkpoint_best")
            ckpt.save_train_state(ckpt_dir, trainable, opt_state, epoch, step=gstep,
                                  metric_best=metric_best, alias="checkpoint_latest")
    return trainable, history


@torch.no_grad()
def calculate_q(model, pairs: Iterable) -> np.ndarray:
    """Per-pixel one-step forecast error variance (model/model.py:469-490).

    pairs yields (inp, tar) normalized (B, 69, H, W) arrays. Returns
    (69, H, W) mean squared error, the Q-matrix diagonal estimate."""
    device = next(model.parameters()).device
    acc, n = None, 0
    for inp, tar in pairs:
        tar = _put(tar, device)
        pred = model(_put(inp, device))[:, :tar.shape[1]]
        sq = ((pred - tar) ** 2).mean(0)
        acc = sq if acc is None else acc + sq
        n += 1
    return (acc / max(n, 1)).cpu().numpy()


@torch.no_grad()
def multi_step_predict(model, inp, steps: int, n_channels: int = channels.N_CHANNELS):
    """Normalized rollout (model/model.py:492-514): (steps, B, C, H, W)."""
    x = _put(inp, next(model.parameters()).device)
    outs = []
    for _ in range(steps):
        x = model(x)[:, :n_channels]
        outs.append(x)
    return torch.stack(outs)
