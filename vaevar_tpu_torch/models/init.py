"""Initial weights with the distributions of the JAX package's flax init.

`run_da` without a checkpoint and without --fast_init initialises its models
as vaevar_tpu/models/lgunet.py's `LGUnet.init` does (run_da.py:275), in
place of torch's defaults (Kaiming-uniform `Linear`, zero position tables):
- every Linear kernel: `_trunc02`, N(0, 0.02^2) truncated at +-2 std
  (lgunet.py:44-55), biases zero; the LoRA `qB` kernel zero (:112-116);
- the relative-position bias tables and both position embeddings:
  `_trunc02` (:125, :487, :550);
- LayerNorm scales one, biases zero;
- the patch-embedding Conv and the ConvTranspose heads: flax's default
  `lecun_normal` (:479-486, :531-538), N(0, s^2) truncated at +-2 s with
  s = sqrt(1 / fan_in) / 0.8796 (flax's variance_scaling correction for the
  truncation), fan_in = kh * kw * input features, biases zero. A torch
  ConvTranspose2d stores its weight as (in, out, kh, kw), so fan_in comes
  from the module's `in_channels`, not from the weight's second axis.

The values are drawn from an explicit torch.Generator, in `named_modules`
order; they are not JAX's values, only their distributions.

`without_default_init` builds a model without torch's default
initialisation, for a model that a fill (utils/fast_init.py, a checkpoint's
strict load, `init_like_flax`) then writes completely.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

_TRUNC_STD = 0.02
# std of a unit normal truncated to [-2, 2]; flax divides by it so that a
# variance-scaling draw keeps the variance it names
_TRUNC_CORRECTION = 0.87962566103423978
_POSITION_TABLES = ("relative_position_bias_table", "absolute_pos_embed", "pos_embed")


def _trunc_normal(t, std, generator):
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_std(fan_in: int) -> float:
    """The std of flax's truncated `lecun_normal` draw before truncation."""
    return (1.0 / fan_in) ** 0.5 / _TRUNC_CORRECTION


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of a port LGUnet (or VAE) in place with a draw
    from the flax initializer of the JAX module's counterpart; returns the
    model. Raises if a parameter has no rule."""
    done = set()

    def fill(p, fn):
        fn(p)
        done.add(id(p))

    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            zero_kernel = name.endswith(".qB")
            fill(m.weight, nn.init.zeros_ if zero_kernel
                 else lambda w: _trunc_normal(w, _TRUNC_STD, generator))
            if m.bias is not None:
                fill(m.bias, nn.init.zeros_)
        elif isinstance(m, nn.LayerNorm):
            fill(m.weight, nn.init.ones_)
            fill(m.bias, nn.init.zeros_)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = m.kernel_size
            std = lecun_std(kh * kw * m.in_channels)
            fill(m.weight, lambda w: _trunc_normal(w, std, generator))
            fill(m.bias, nn.init.zeros_)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _POSITION_TABLES:
            fill(p, lambda t: _trunc_normal(t, _TRUNC_STD, generator))
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise ValueError(f"no flax initializer rule for {missed[:5]}")
    return model


# the layers whose constructors draw torch's default initialisation
# (Conv2d and ConvTranspose2d take theirs from _ConvNd)
_DEFAULT_INIT = (nn.Linear, nn.LayerNorm, nn.modules.conv._ConvNd)
_NO_INIT_LOCK = threading.Lock()


@contextlib.contextmanager
def without_default_init():
    """Inside the block, Linear, LayerNorm and the conv layers skip their
    `reset_parameters`: their parameters hold uninitialised memory, and the
    default initialisers' draws (a few seconds for a 427 M-parameter model)
    are not made. Only for a model whose every parameter a fill writes
    afterwards; buffers are computed as always. It patches the classes for
    the length of the block, so blocks in several threads run one at a
    time (keep them to the construction) and must not nest."""
    with _NO_INIT_LOCK:
        saved = {cls: cls.__dict__["reset_parameters"] for cls in _DEFAULT_INIT}
        for cls in saved:
            cls.reset_parameters = lambda self: None
        try:
            yield
        finally:
            for cls, fn in saved.items():
                cls.reset_parameters = fn
