"""Random weights drawn on the device from a seed, handed to both sides.

The distributions are those of the flax initializers the JAX package uses
(as vaevar_tpu_torch/models/init.py documents them):

- Linear kernels, relative-position bias tables and position embeddings:
  N(0, 0.02^2) truncated at +-2 std; biases zero; LoRA `qB` zero;
- LayerNorm scales one, biases zero;
- Conv2d and ConvTranspose2d kernels: flax's lecun_normal, N(0, s^2)
  truncated at +-2 s, s = sqrt(1 / fan_in) / 0.8796, fan_in = kh * kw *
  input channels (a ConvTranspose2d weight is (in, out, kh, kw)); biases
  zero.

One uniform draw of every random leaf's length together, on the device,
from a torch.Generator seeded by (seed, role), turned into the truncated
normal by the inverse CDF. Leaves are laid out in sorted name order, so the
program's model and the reference, which share parameter names and shapes,
receive the same values.
"""

from __future__ import annotations

import math

import torch

_CORRECTION = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
_ROLES = {"decoder": 1, "forecast": 3}


def _rule(name: str, shape, convs: dict):
    """('zero' | 'one' | std) of the leaf `name`."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 1)[0]
    if leaf in ("relative_position_bias_table", "absolute_pos_embed", "pos_embed"):
        return 0.02
    if owner in convs:
        if leaf == "bias":
            return "zero"
        return math.sqrt(1.0 / convs[owner]) / _CORRECTION
    if leaf == "bias":
        return "zero"
    if len(shape) == 1:  # a LayerNorm scale
        return "one"
    if owner.endswith(".qB"):
        return "zero"
    return 0.02


def conv_fan_in(model: torch.nn.Module) -> dict:
    """{module name: fan_in} of the model's convolutions."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            kh, kw = m.kernel_size
            out[name] = kh * kw * m.in_channels
    return out


def generator(seed: int, role: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + _ROLES[role]) % (2 ** 63))
    return g


@torch.no_grad()
def values(model: torch.nn.Module, seed: int, role: str):
    """(name, value) of every parameter of `model` in sorted name order, as
    the draw of (seed, role) gives it, on the parameters' device; each value
    is made when it is reached."""
    params = dict(model.named_parameters())
    convs = conv_fan_in(model)
    names = sorted(params)
    rules = {n: _rule(n, params[n].shape, convs) for n in names}
    device = params[names[0]].device
    total = sum(params[n].numel() for n in names if not isinstance(rules[n], str))
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(total, generator=generator(seed, role, device), device=device)
    z = u.mul_(hi - lo).add_(lo).mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2))
    z.clamp_(-2.0, 2.0)
    at = 0
    for n in names:
        p, rule = params[n], rules[n]
        if rule == "zero":
            yield n, torch.zeros_like(p)
        elif rule == "one":
            yield n, torch.ones_like(p)
        else:
            k = p.numel()
            yield n, z[at:at + k].view(p.shape) * rule
            at += k


@torch.no_grad()
def draw(model: torch.nn.Module, seed: int, role: str):
    """Fill every parameter of `model` in place (on its device) with the
    draw of (seed, role); returns the model."""
    params = dict(model.named_parameters())
    for name, value in values(model, seed, role):
        params[name].copy_(value)
    return model
