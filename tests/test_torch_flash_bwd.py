"""The port's flash-attention backward against the JAX package's.

The plain backward (the CPU path, and the kernels' reference on the card) is
held against `jax.grad` of the Pallas flash attention run in interpret mode
(its _dq_kernel and _dkv_kernel, as tests/test_flash.py runs them) and of the
lax.scan flash of ops/flash.py, at the shapes and block sizes of
tests/test_flash.py, blocks that do not divide N included.

Tolerances, per gradient:
- an f32 gradient (all of them in f32; dq and dk with f32 q, k and bf16 v):
  atol 2e-6 x max |reference|. Both sides sum the same f32 products over
  N <= 300 keys or queries in another block order: a few ulp.
- a bf16 gradient (dv with bf16 v; all three in bf16): one bf16 ulp of each
  entry, rtol 2^-7 (bf16 keeps 8 significant bits), plus atol 2^-12 x max
  |reference| for entries near zero. Both sides round the same values to
  bf16; f32 noise can carry one across a rounding boundary. Dropping any
  one of the roundings of dS, P^T or dS^T from the plain backward breaks
  this by hundreds of entries at the bf16 shape below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rand
from vaevar_tpu.ops import flash as jflash
from vaevar_tpu.ops import pallas_attn
from vaevar_tpu_torch.ops import flash_attn as fa
from vaevar_tpu_torch.utils import trace


def _launches():
    """The flash kernels' launch counters (fwd, dq, dkv) of this process."""
    c = trace.counters()
    return tuple(c.get(f"flash.{k}", 0) for k in ("fwd", "dq", "dkv"))

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, jnp.float32), "mixed": (jnp.float32, jnp.bfloat16),
          "bfloat16": (jnp.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed, kind):
    """q (pre-scaled), k, v, and the cotangent g, as numpy f32 values that
    the chosen dtypes represent exactly."""
    qk_dt, v_dt = DTYPES[kind]
    d = shape[-1]
    q, k, v, g = (rand(shape, seed + i, d ** -0.5 if i == 0 else 1.0) for i in range(4))
    q, k, g = (np.asarray(jnp.asarray(a, qk_dt), np.float32) for a in (q, k, g))
    return q, k, np.asarray(jnp.asarray(v, v_dt), np.float32), g


def _to_torch(arrays, kind):
    qk_dt = torch.float32 if kind != "bfloat16" else torch.bfloat16
    v_dt = torch.float32 if kind == "float32" else torch.bfloat16
    q, k, v, g = (torch.tensor(a) for a in arrays)
    return q.to(qk_dt), k.to(qk_dt), v.to(v_dt), g.to(qk_dt)


def _jax_grads(fn, arrays, kind):
    qk_dt, v_dt = DTYPES[kind]
    q, k, v, g = (jnp.asarray(a, dt) for a, dt in zip(arrays, (qk_dt, qk_dt, v_dt, qk_dt)))
    loss = lambda q, k, v: jnp.sum((fn(q, k, v) * g).astype(jnp.float32))
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _assert_close(got, want, kind):
    for name, a, b in zip("qkv", got, want):
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=2 ** -7 if bf16 else 0,
                                   atol=(2 ** -12 if bf16 else 2e-6) * scale,
                                   err_msg=f"d{name} ({kind})")


@pytest.mark.parametrize("shape,blocks,kind", [
    ((2, 2, 300, 64), (128, 128), "float32"),
    ((1, 2, 200, 32), (128, 128), "float32"),
    ((1, 2, 200, 32), (128, 128), "mixed"),
    ((1, 1, 256, 64), (128, 128), "bfloat16")])
def test_plain_backward_matches_pallas_kernels(shape, blocks, kind):
    """The backward alone: the Pallas forward's O and lse go through
    _bwd_call (_dq_kernel and _dkv_kernel in interpret mode) and through
    flash_attention_bwd_plain."""
    arrays = _inputs(shape, 40, kind)
    qk_dt, v_dt = DTYPES[kind]
    B, h, N, d = shape
    q, k, v, g = (jnp.asarray(a.reshape(B * h, N, d), dt)
                  for a, dt in zip(arrays, (qk_dt, qk_dt, v_dt, qk_dt)))
    o, lse = pallas_attn._fwd_call(q, k, v, *blocks, interpret=True)
    want = pallas_attn._bwd_call(q, k, v, o, lse, g, *blocks, interpret=True)
    qt, kt, vt, gt = _to_torch(arrays, kind)
    ot = torch.tensor(np.asarray(o, np.float32).reshape(shape)).to(qt.dtype)
    lset = torch.tensor(np.asarray(lse).reshape(B, h, N))
    got = fa.flash_attention_bwd_plain(qt, kt, vt, ot, lset, gt, *blocks)
    assert [t.dtype for t in got] == [qt.dtype, kt.dtype, vt.dtype]
    _assert_close([t.reshape(B * h, N, d) for t in got], want, kind)


@pytest.mark.parametrize("shape,blocks", [((1, 1, 130, 8), (64, 48)),
                                          ((1, 2, 200, 16), (64, 64))])
def test_plain_backward_matches_scan_flash_ragged_blocks(shape, blocks):
    arrays = _inputs(shape, 20, "float32")
    want = _jax_grads(lambda q, k, v: jflash.flash_attention(q, k, v, *blocks),
                      arrays, "float32")
    q, k, v, g = _to_torch(arrays, "float32")
    o, lse = fa.flash_attention_plain(q, k, v, *blocks)
    _assert_close(fa.flash_attention_bwd_plain(q, k, v, o, lse, g, *blocks), want, "float32")


def test_block_sizes_do_not_change_the_gradient():
    """Blocks that do not divide N slice the ragged tail; the gradient is
    the same sum in another order."""
    q, k, v, g = _to_torch(_inputs((1, 2, 130, 16), 21, "float32"), "float32")
    o, lse = fa.flash_attention_plain(q, k, v)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, g)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, 64, 48)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2e-6 * b.abs().max().item())


@pytest.mark.parametrize("kind", ["float32", "mixed"])
def test_cpu_autograd_runs_the_plain_backward(monkeypatch, kind):
    """The fix of the CPU path: autograd through flash_attention is the
    custom VJP (its backward is flash_attention_bwd_plain, called once, and
    no kernel launches), and its gradient is the Pallas kernels' one. Both
    forwards take all 200 keys in one block (the port's default blocks;
    Pallas clamps its to 256), so P rounds to bf16 at the same logits."""
    calls = []
    real = fa.flash_attention_bwd_plain
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    arrays = _inputs((1, 2, 200, 32), 50, kind)
    want = _jax_grads(lambda q, k, v: pallas_attn.flash_attention(q, k, v, 512, 1024, True),
                      arrays, kind)
    q, k, v, g = _to_torch(arrays, kind)
    for t in (q, k, v):
        t.requires_grad_(True)
    launches = _launches()
    (fa.flash_attention(q, k, v) * g).sum().backward()
    assert calls == [1]
    assert _launches() == launches
    _assert_close([q.grad, k.grad, v.grad], want, kind)


def test_cpu_backward_keeps_no_attention_matrix():
    """The forward saves q, k, v, O and lse (O(N d)); autograd no longer
    keeps each block's P (O(N^2))."""
    shape = (1, 1, 1024, 16)
    q, k, v = (torch.from_numpy(rand(shape, i)).requires_grad_(True) for i in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = fa.flash_attention(q, k, v)
    assert sum(saved) <= 4 * q.numel() + 1024 < 1024 ** 2
    out.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))

