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
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple

import numpy as np
import torch

from vaevar_tpu_torch import channels


def lp_loss(pred, target):
    B = pred.shape[0]
    d = torch.linalg.vector_norm(pred.reshape(B, -1) - target.reshape(B, -1), dim=1)
    n = torch.linalg.vector_norm(target.reshape(B, -1), dim=1)
    return (d / n).mean()


def poss_loss(pred, target, max_logvar, min_logvar, inc_var_loss: bool = True):
    """Gaussian NLL with clamped logvar; pred has 2x target channels."""
    mean, logvar = torch.chunk(pred, 2, dim=1)
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


def cosine_decay(step: int, total_steps: int) -> float:
    """optax.cosine_decay_schedule's factor (alpha 0) at update `step`."""
    t = min(step, total_steps) / total_steps
    return 0.5 * (1.0 + math.cos(math.pi * t))


class OptState(NamedTuple):
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR


def _loss(trainable, inp, tars, loss_type, two_step):
    """(loss, first prediction) of the one- or two-step objective."""
    model = trainable["model"]
    nch = tars[0].shape[1]

    def one(pred, tar):
        if loss_type == "Possloss":
            return poss_loss(pred, tar, trainable["max_logvar"], trainable["min_logvar"])
        return lp_loss(pred[:, :tar.shape[1]], tar)

    pred = model(inp)
    loss = one(pred, tars[0])
    if two_step and len(tars) > 1:
        loss = loss + one(model(pred[:, :nch]), tars[1])
    return loss, pred


def make_forecast_train_step(
    model: torch.nn.Module,
    loss_type: str = "Possloss",
    lr: float = 5e-6,
    total_steps: int = 10_000,
    two_step: bool = False,
    out_shape=None,  # (out_chans, H, W) needed for Possloss logvar bounds
):
    """-> (init_fn, train_step). `init_fn()` builds the trainable around
    `model` (on its device) and its optimizer state; `train_step(trainable,
    opt_state, inp, tars)` takes one AdamW step in place and returns
    (trainable, opt_state, loss)."""

    def init_fn():
        trainable = {"model": model}
        if loss_type == "Possloss":
            c, h, w = out_shape
            n = c * h * w // 2
            dev = next(model.parameters()).device
            trainable["max_logvar"] = torch.full((1, n), 0.5, device=dev, requires_grad=True)
            trainable["min_logvar"] = torch.full((1, n), -10.0, device=dev, requires_grad=True)
        params = list(model.parameters()) + [
            trainable[k] for k in ("max_logvar", "min_logvar") if k in trainable]
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.9), eps=1e-8,
                                weight_decay=1e-4)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda s: cosine_decay(s, total_steps))
        return trainable, OptState(opt, sched)

    def train_step(trainable, opt_state, inp, tars):
        opt_state.optimizer.zero_grad(set_to_none=True)
        loss, _ = _loss(trainable, inp, tars, loss_type, two_step)
        loss.backward()
        opt_state.optimizer.step()
        opt_state.scheduler.step()
        return trainable, opt_state, loss.detach()

    return init_fn, train_step


def make_eval_step(loss_type: str = "Possloss", two_step: bool = False):
    """Validation step (reference basemodel.test_one_step,
    model/model.py:235-257): the training loss plus the prediction's mean
    half, without gradients."""

    @torch.no_grad()
    def eval_step(trainable, inp, tars):
        loss, pred = _loss(trainable, inp, tars, loss_type, two_step)
        return loss, pred[:, :tars[0].shape[1]]

    return eval_step


def _device_of(trainable):
    return next(trainable["model"].parameters()).device


def _put(batch, device):
    return torch.as_tensor(np.asarray(batch), dtype=torch.float32).to(device)


def evaluate(eval_step, trainable, val_iter: Iterable, recorder=None,
             data_std=None) -> dict:
    """Run the validation loop; returns mean scalars over batches (the
    reference's basemodel.test, model/model.py:414-431). `recorder` is a
    utils.metrics.MetricsRecorder, evaluated on the normalized fields with
    data_std scaling to physical units."""
    device = _device_of(trainable)
    sums, n = {}, 0
    for inp, tars in val_iter:
        tars_t = [_put(t, device) for t in tars]
        loss, pred = eval_step(trainable, _put(inp, device), tars_t)
        scalars = {"loss": float(loss)}
        if recorder is not None:
            scalars.update(recorder.evaluate_batch(
                {"pred": pred, "gt": tars_t[0], "std": data_std}))
        for k, v in scalars.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


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
    true global step, so a resumed run continues the scalar stream. The
    JAX version's `mesh` (data-parallel training) waits for ROADMAP A.13."""
    from vaevar_tpu_torch.train import checkpoint as ckpt

    total = (steps_per_epoch or 1000) * epochs
    init_fn, train_step = make_forecast_train_step(
        model, loss_type=loss_type, lr=lr, total_steps=total,
        two_step=two_step, out_shape=out_shape)
    trainable, opt_state = init_fn()
    eval_step = make_eval_step(loss_type, two_step)
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
            trainable, opt_state, loss = train_step(
                trainable, opt_state, _put(inp, device), [_put(t, device) for t in tars])
            loss = float(loss)
            if (j + 1) % log_every == 0:
                logger(f"epoch {epoch} iter {j} loss {loss:.4f}")
            history.append(loss)
            if writer is not None:
                writer.add_scalar("loss", loss, gstep)
            gstep += 1
        val = {}
        if val_factory is not None:
            model.eval()
            val = evaluate(eval_step, trainable, val_factory(), recorder, data_std)
            shown = {k: v for k, v in val.items() if not k[-1].isdigit()}
            if writer is not None:
                writer.add_scalars({f"val_{k}": v for k, v in shown.items()}, epoch)
            shown.update({  # the reference's channels of record
                k: val[k] for k in ("WRMSE11", "WRMSE66", "WRMSE2") if k in val})
            logger(f"epoch {epoch} val: " + " ".join(
                f"{k} {v:.4g}" for k, v in sorted(shown.items())))
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
