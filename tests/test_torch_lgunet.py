"""The port's LGUnet against the JAX LGUnet with bridged weights.

f32 forward: rtol 1e-4, atol 1e-5 (outputs are O(0.1); the two frameworks
sum matmuls and layer norms in different orders, a few f32 ulp per layer).
Gradient of sum(out * g) with respect to the input: the same tolerance on
the gradient scale. bf16 forward: atol 2e-3 of outputs O(0.1); both sides
round the same tensors to bf16, but a value near a bf16 rounding boundary
can round the other way after f32 noise, one bf16 ulp (2^-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import model_pair, rand
from vaevar_tpu import config as C

torch.set_num_threads(1)

CONFIGS = {
    "micro_vae_decoder_relbias": C.micro_vae_configs(img_size=(32, 64))[1],
    "micro_rope_flash_stage": C.micro_config(img_size=(32, 64), flash_min_seq=16),
    "micro_rope_patch32_odd_height": C.micro_config(
        img_size=(33, 64), patch_size=(3, 2), enc_depths=(2, 2, 2),
        enc_heads=(1, 1, 1), lg_depths=(2, 2), lg_heads=(2, 2), flash_min_seq=16),
}


def _forward_pair(cfg, seed=5):
    jm, params, tm = model_pair(cfg)
    x = rand((1, sum(cfg.inchans_list), *cfg.img_size), seed)
    y_j = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x)).numpy()
    return y_j, y_t


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_f32(name):
    y_j, y_t = _forward_pair(CONFIGS[name])
    assert y_t.shape == y_j.shape and y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-5)


def test_flash_stage_takes_the_flash_path(monkeypatch):
    """The rope micro config's full-grid LG stage (N = 8*16 = 128 >= 16)
    runs through flash_attention, once per block (its unshifted 4x4
    encoder windows, N = 16, do too)."""
    from vaevar_tpu_torch.ops import attention

    seen = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v: seen.append(q.shape) or real(q, k, v))
    cfg = CONFIGS["micro_rope_flash_stage"]
    _, _, tm = model_pair(cfg)
    with torch.no_grad():
        tm(torch.zeros(1, 69, *cfg.img_size))
    assert [s for s in seen if s[2] == 128] == [(1, 1, 128, 16)] * cfg.lg_depths[0]


def test_decoder_input_gradient():
    cfg = CONFIGS["micro_vae_decoder_relbias"]
    jm, params, tm = model_pair(cfg)
    x = rand((1, 8, 32, 64), 6)
    g = rand((1, 69, 32, 64), 7)
    gj = np.asarray(jax.jit(jax.grad(lambda z: jnp.sum(jm.apply(params, z) * g)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm(xt) * torch.from_numpy(g)).sum().backward()
    scale = np.abs(gj).max()
    np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["micro_vae_decoder_relbias", "micro_rope_flash_stage"])
def test_forward_bf16(name):
    cfg = CONFIGS[name].replace(dtype=jnp.bfloat16)
    y_j, y_t = _forward_pair(cfg)
    assert y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=2e-3)
