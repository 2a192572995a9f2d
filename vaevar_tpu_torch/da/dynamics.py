"""Forecast integration on physical fields.

Port of vaevar_tpu/da/dynamics.py: normalise, apply the model `steps`
times keeping the first 69 output channels (the mean head), denormalise,
with an optional nearest resize to and from the model's grid. Under
autograd each step of a multi-step integration and of the window rollout
runs under torch.utils.checkpoint, as the reference's steps run under
jax.checkpoint, so a backward recomputes a step instead of storing it.

A 4D-Var window cost runs its flow steps through `traced_step`: counter
`window.flow_forwards` (every execution of the step, a checkpoint's
recompute included) and device span `window.step` (utils/trace.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.ops.interp import resize_nearest
from vaevar_tpu_torch.utils import trace
from vaevar_tpu_torch.utils.capture import checkpoint, device_tables


def checkpointed(fn: Callable) -> Callable:
    """fn under torch.utils.checkpoint when autograd records (the
    reference's jax.checkpoint); fn itself otherwise, where there is nothing
    to rematerialise (no_grad, forward-mode probes)."""

    def run(*args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args)
        return fn(*args)

    return run


def traced_step(fn: Callable) -> Callable:
    """fn, one flow step of a window cost, counted in `window.flow_forwards`
    and spanned by the device span `window.step` at every execution: wrapped
    inside a checkpoint, a backward's recompute counts and spans again."""

    def run(*args):
        trace.count("window.flow_forwards")
        with trace.span("window.step", device=True):
            return fn(*args)

    return run


def make_integrate(model: torch.nn.Module, model_hw=None):
    """integrate(x, steps, interpolation) for x (69, H, W) in physical units."""

    def step(z):
        return model(z)[:, : channels.N_CHANNELS]

    remat_step = checkpointed(step)

    @device_tables
    def norm(device):
        return tuple(torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1, 1, 1)
                     for t in (channels.MEAN, channels.STD))

    def integrate(x, steps: int, interpolation: bool = False):
        mean, std = norm(x.device)
        hw = tuple(x.shape[-2:])
        z = ((x - mean) / std)[None]
        resize = interpolation and model_hw is not None and hw != tuple(model_hw)
        if resize:
            z = resize_nearest(z, model_hw)
        for _ in range(steps):
            z = step(z) if steps == 1 else remat_step(z)
        if resize:
            z = resize_nearest(z, hw)
        return z[0] * std + mean

    return integrate


def rollout_window(x0, flow_step: Callable, da_win: int):
    """States at each of the `da_win` hourly slots: (da_win, 69, H, W).

    flow_step(x) advances one hour in physical units; each step is
    checkpointed under autograd."""
    if da_win == 1:
        return x0[None]
    step = checkpointed(flow_step)
    states = [x0]
    for _ in range(da_win - 1):
        states.append(step(states[-1]))
    return torch.stack(states)
