"""Shared set-up of the port's parity tests (tests/test_torch_*.py): the same
numpy-seeded inputs and the same weights for the JAX package and the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
from vaevar_tpu.utils.fast_init import fast_init
from vaevar_tpu_torch.models.lgunet import LGUnet as TorchLGUnet
from vaevar_tpu_torch.utils.port_jax import lgunet_state_dict_from_flax


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def flax_params(cfg, seed=1):
    """Random N(0, 0.02^2) flax params for an LGUnet config, as numpy."""
    x = jnp.zeros((1, sum(cfg.inchans_list), *cfg.img_size), jnp.float32)
    return jax.tree.map(np.asarray, fast_init(JaxLGUnet(cfg), x, seed=seed))


def model_pair(cfg, seed=1):
    """(JAX module, its params, port module with the same weights)."""
    params = flax_params(cfg, seed)
    port = TorchLGUnet(cfg)
    port.load_state_dict(lgunet_state_dict_from_flax(params, cfg), strict=True)
    return JaxLGUnet(cfg), params, port.eval()


def quadratic(seed: int, n: int = 64, cond_pow: float = 4.0):
    """Random SPD quadratic (A, b) with condition number 10**cond_pow (the
    generator of tests/test_lbfgs_torch_trajectory.py)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.logspace(0.0, cond_pow, n)
    A = ((Q * eig) @ Q.T).astype(np.float32)
    A = (A + A.T) / 2
    b = rng.normal(size=n).astype(np.float32)
    return A, b


def to_np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)
