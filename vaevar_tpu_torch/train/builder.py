"""Optimizer, learning-rate schedule and trainable-mask factories.

Port of vaevar_tpu/train/builder.py (the reference's ConfigBuilder optimizer
zoo, utils/builder.py:300-382) with optax's update rules, not torch.optim's
defaults where the two differ:
- SGD, ASGD (SGD, as in the JAX package), Adam, AdamW and Adadelta are the
  torch.optim classes set to optax's constants: their updates are optax's
  formulas (AdamW's decay is decoupled in both; Adadelta's eps is 1e-6 inside
  both square roots and lr a plain scale);
- Adagrad, Adamax and RMSprop are written out below: optax's Adagrad starts
  its accumulator at 0.1 and puts eps 1e-7 inside the square root, its
  RMSprop puts eps inside the square root, and its Adamax adds eps to |g|
  in the infinity norm.
A schedule is a function of the update count, as optax's are; `ScheduleLR`
sets an optimizer's rate from one after each step, so update k runs at
schedule(k). `lora_mask` and `finetune_optimizer` realize the reference's
`VAE_lr.finetune()` (nf_model/vae.py:92-97): only the LoRA projections
train, and the frozen parameters get no update and no weight decay.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

_LORA_KEYS = ("qA", "qB", "kA", "kB", "vA", "vB")


def make_schedule(params: Mapping[str, Any] | None, base_lr: float,
                  total_steps: int) -> Callable[[int], float]:
    """timm-style schedule spec -> a function of the update count.

    keys: sched ('cosine'|'step'|'constant'), warmup_epochs/warmup_steps,
    min_lr, decay_rate, decay_steps (optax's cosine_decay_schedule,
    exponential_decay with staircase and end_value, constant_schedule,
    and linear warmup from 0 joined in front)."""
    p = dict(params or {})
    kind = p.get("sched", "cosine")
    warmup = int(p.get("warmup_steps", p.get("warmup_epochs", 0)))
    min_lr = float(p.get("min_lr", 0.0))
    if kind == "cosine":
        decay = max(total_steps - warmup, 1)
        alpha = min_lr / base_lr if base_lr else 0.0

        def main(count):
            c = 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
            return base_lr * ((1.0 - alpha) * c + alpha)
    elif kind == "step":
        steps = int(p.get("decay_steps", max(total_steps // 3, 1)))
        rate = float(p.get("decay_rate", 0.1))
        clip = max if rate < 1.0 else min  # min_lr is optax's end_value

        def main(count):
            if rate == 0.0:
                return base_lr
            return clip(base_lr if count <= 0 else base_lr * rate ** (count // steps), min_lr)
    elif kind == "constant":
        def main(count):
            return base_lr
    else:
        raise NotImplementedError(f"schedule {kind}")
    if warmup:
        return lambda count: (base_lr * min(max(count, 0), warmup) / warmup
                              if count < warmup else main(count - warmup))
    return main


class ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Every group's rate is `schedule(k)` after k scheduler steps."""

    def __init__(self, optimizer, schedule: Callable[[int], float]):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self):
        return [float(self.schedule(self.last_epoch))] * len(self.optimizer.param_groups)


class Adagrad(torch.optim.Optimizer):
    """optax.adagrad: s = s + g^2 from s0 = 0.1; p -= lr g / sqrt(s + eps)."""

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                s = st["sum"].add_(p.grad * p.grad)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
                p.sub_(group["lr"] * scale * p.grad)


class Adamax(torch.optim.Optimizer):
    """optax.adamax: m = b1 m + (1 - b1) g; u = max(|g| + eps, b2 u);
    p -= lr m / (1 - b1^t) / u."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                st["step"] += 1
                mu = st["mu"].mul_(b1).add_((1 - b1) * p.grad)
                nu = torch.maximum(p.grad.abs() + group["eps"], b2 * st["nu"])
                st["nu"] = nu
                p.sub_(group["lr"] * (mu / (1 - b1 ** st["step"])) / nu)


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: v = decay v + (1 - decay) g^2 from 0;
    u = lr g / sqrt(v + eps), then optax.trace(momentum): t = momentum t + u;
    p -= t."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, momentum=0.0, nesterov=False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d, mom = group["decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(nu=torch.zeros_like(p), trace=torch.zeros_like(p))
                nu = st["nu"].mul_(d).add_((1 - d) * p.grad * p.grad)
                u = group["lr"] * p.grad * torch.rsqrt(nu + group["eps"])
                t = st["trace"].mul_(mom).add_(u)
                p.sub_(u + mom * t if group["nesterov"] else t)


def make_optimizer(params, opt_type: str = "AdamW", lr: float = 1e-4,
                   weight_decay: float = 0.0, **kw) -> torch.optim.Optimizer:
    """Name-compatible optimizer factory (utils/builder.py:332-351) over
    `params` (an iterable of tensors or of param groups). A schedule goes on
    top through ScheduleLR."""
    t = opt_type.lower()
    b1, b2 = kw.get("b1", 0.9), kw.get("b2", 0.999)
    if t == "sgd":
        return torch.optim.SGD(params, lr, momentum=kw.get("momentum", 0.0),
                               nesterov=kw.get("nesterov", False))
    if t == "asgd":  # optax has no ASGD; SGD is the convex-phase equivalent
        return torch.optim.SGD(params, lr)
    if t == "adagrad":
        return Adagrad(params, lr)
    if t == "adamax":
        return Adamax(params, lr, betas=(b1, b2))
    if t == "adadelta":
        return torch.optim.Adadelta(params, lr, rho=kw.get("rho", 0.9), eps=1e-6)
    if t == "adam":
        return torch.optim.Adam(params, lr, betas=(b1, b2), eps=1e-8)
    if t == "adamw":
        return torch.optim.AdamW(params, lr, betas=(b1, b2), eps=1e-8,
                                 weight_decay=weight_decay)
    if t == "rmsprop":
        return RMSprop(params, lr, decay=kw.get("alpha", 0.99),
                       momentum=kw.get("momentum", 0.0))
    raise NotImplementedError(f"optimizer {opt_type}")


def lora_mask(model: torch.nn.Module) -> dict[str, bool]:
    """{parameter name: True for a LoRA adapter (qA/qB/kA/kB/vA/vB), else
    False}."""
    return {name: any(part in _LORA_KEYS for part in name.split("."))
            for name, _ in model.named_parameters()}


def finetune_optimizer(model: torch.nn.Module, opt_type: str = "Adam", lr: float = 1e-4,
                       **kw) -> torch.optim.Optimizer:
    """An optimizer over the LoRA adapters alone: every other parameter of
    `model` stays as it is, with no update and no decay."""
    mask = lora_mask(model)
    lora = [p for name, p in model.named_parameters() if mask[name]]
    if not lora:
        raise ValueError("finetune_optimizer: the model has no LoRA parameters")
    return make_optimizer(lora, opt_type, lr, **kw)
