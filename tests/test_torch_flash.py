"""The port's flash-attention forward against the JAX kernels.

The plain version (the CPU path, and the kernel's reference on the card) is
held against the Pallas kernel run in interpret mode, as tests/test_flash.py
runs it, and against the lax.scan flash of ops/flash.py. f32 tolerance 2e-5:
the block order of the online softmax differs, which moves O(1) outputs by a
few ulp per block; bf16 3e-2: P and the output round to bf16 (2^-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rand
from vaevar_tpu.ops import flash as jflash
from vaevar_tpu.ops import pallas_attn
from vaevar_tpu_torch.ops import flash_attn as fa
from vaevar_tpu_torch.utils import trace

torch.set_num_threads(1)


def _qkv(shape, seed):
    d = shape[-1]
    return rand(shape, seed, d ** -0.5), rand(shape, seed + 1), rand(shape, seed + 2)


def test_plain_matches_pallas_interpret():
    q, k, v = _qkv((2, 2, 300, 64), 30)
    o_t, lse_t = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                          128, 128)
    o_p = pallas_attn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), 128, 128, True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_p), atol=2e-5)
    flat = [jnp.asarray(a.reshape(4, 300, 64)) for a in (q, k, v)]
    o_f, lse_f = pallas_attn._fwd_call(*flat, 128, 128, interpret=True)
    np.testing.assert_allclose(o_t.numpy().reshape(4, 300, 64), np.asarray(o_f), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy().reshape(4, 300), np.asarray(lse_f), atol=2e-5)


def test_plain_matches_scan_flash_ragged_blocks():
    q, k, v = _qkv((1, 1, 130, 8), 20)
    o_t, lse_t = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), 64, 48)
    o_j, m_j, l_j = jflash._forward(*(jnp.asarray(a) for a in (q, k, v)), 64, 48)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(m_j + jnp.log(l_j)), atol=2e-5)


def test_plain_bf16_matches_pallas_interpret():
    q, k, v = (a.astype(np.float32) for a in _qkv((1, 1, 256, 64), 50))
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    o_t, _ = fa.flash_attention_plain(qt, kt, vt, 128, 128)
    assert o_t.dtype == torch.bfloat16
    o_p = pallas_attn.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                      128, 128, True)
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_p, np.float32), atol=3e-2)


def test_plain_mixed_dtypes_match_scan_flash():
    """The rope stage hands flash f32 q, k and bf16 v: P rounds to bf16 and
    O comes out f32, as in the JAX package. atol 2e-4: a logit that differs
    by f32 round-off can round its P entry to the neighbouring bf16 value,
    which moves O by up to 2^-8 * p * |v|."""
    q, k, v = _qkv((1, 2, 200, 32), 60)
    vt = torch.from_numpy(v).bfloat16()
    o_t, _ = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), vt, 64, 64)
    o_j = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v, jnp.bfloat16), 64, 64)
    assert o_t.dtype == torch.float32 and o_j.dtype == jnp.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-4)


def test_cpu_dispatch_is_plain_and_differentiable():
    """CPU tensors take the plain path (no kernel launch), whose autograd
    gradient matches dense attention's."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv((1, 2, 70, 16), 70))
    g = torch.from_numpy(rand((1, 2, 70, 16), 99))
    before = trace.counters().get("flash.fwd", 0)
    (fa.flash_attention(q, k, v) * g).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (torch.softmax(q @ k.transpose(-1, -2), -1) @ v * g).sum().backward()
    for a, t in zip(grads, (q, k, v)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=1e-5)
    assert trace.counters().get("flash.fwd", 0) == before


def test_kernel_wrapper_refuses_cpu_tensors_and_backward():
    """The kernel wrappers take CUDA tensors only; on CPU tensors the custom
    VJP's backward runs (the plain backward) and gives finite gradients."""
    q = torch.zeros(1, 1, 8, 32)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_cuda(q, q, q, q, lse, q)
    qg = torch.from_numpy(rand((1, 1, 8, 32), 71)).requires_grad_(True)
    fa.flash_attention(qg, q, q + 1).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
