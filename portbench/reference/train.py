"""Plain float32 training step of the forecast model: Possloss and AdamW.

Possloss (the reference's model/model.py): the model's output halves are a
mean and a log-variance; the log-variance is soft-clamped between two
learnable bounds (1, C H W), max_logvar (init 0.5) and min_logvar (init
-10):

    lv = max - softplus(max - lv);  lv = min + softplus(lv - min)
    loss = mean_b[mean_chw((mu - y)^2 exp(-lv)) + mean_chw(lv)]
           + 0.01 mean(max) - 0.01 mean(min)

AdamW as optax.adamw(cosine_decay_schedule(lr, total), b1=0.9, b2=0.9,
eps=1e-8, weight_decay=1e-4) on every parameter, the bounds included: update
k (from 0) uses lr * (1 + cos(pi min(k, total) / total)) / 2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.9)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


def possloss(pred, target, max_logvar, min_logvar):
    mean, logvar = torch.chunk(pred, 2, dim=1)
    B = pred.shape[0]
    lv = logvar.reshape(B, -1)
    lv = max_logvar - F.softplus(max_logvar - lv)
    lv = min_logvar + F.softplus(lv - min_logvar)
    lv = lv.reshape(target.shape)
    per = ((mean - target) ** 2 * torch.exp(-lv)).mean(dim=(1, 2, 3)) + lv.mean(dim=(1, 2, 3))
    return (per + 0.01 * max_logvar.mean() - 0.01 * min_logvar.mean()).mean()


def cosine_lr(lr, k, total):
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(k, total) / total))


class AdamW:
    """Decoupled weight decay Adam over a list of parameters, step by step."""

    def __init__(self, params, lr, total_steps):
        self.params = list(params)
        self.lr, self.total, self.k = lr, total_steps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        lr = cosine_lr(self.lr, self.k, self.total)
        self.k += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.k, 1 - b2 ** self.k
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1 - lr * WEIGHT_DECAY)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m / c1, (v / c2).sqrt().add_(EPS), value=-lr)
