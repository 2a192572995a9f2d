"""The CUDA flash-forward kernel against its plain version, on the card.

These tests need a CUDA device and skip without one. The file imports no JAX,
so it also runs on a machine without it; tests/conftest.py imports JAX, so
there run it with

    python -m pytest --noconftest -q -m gpu tests/test_torch_flash_card.py

Tolerances: atol 1e-4 in f32 (the kernel and the plain version sum in
another order). With bf16 v, 4e-3: P is rounded to bf16 before P.V, and a
P entry whose f32 logit differs by round-off can round to the neighbouring
bf16 value (2^-8 relative), which moves O by up to 2^-8 * p * |v|; a bf16
O also rounds (half an ulp at |O| < 1 is 2e-3). lse is f32 on both sides.
"""

import numpy as np
import pytest
import torch

from vaevar_tpu_torch.ops import flash_attn as fa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(shape, seed, device, qk_dtype=torch.float32, v_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(3))
    q *= shape[-1] ** -0.5
    return (torch.from_numpy(q).to(device, qk_dtype), torch.from_numpy(k).to(device, qk_dtype),
            torch.from_numpy(v).to(device, v_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", [
    ((2, 2, 300, 64), ("float32", "float32")),
    ((1, 1, 130, 32), ("float32", "float32")),
    ((1, 3, 257, 128), ("float32", "float32")),
    ((1, 2, 300, 192), ("bfloat16", "bfloat16")),
    ((1, 2, 300, 192), ("float32", "bfloat16"))])
def test_kernel_matches_plain(cuda, shape, dtypes):
    qk_dt, v_dt = (getattr(torch, n) for n in dtypes)
    q, k, v = _qkv(shape, 80, cuda, qk_dt, v_dt)
    before = fa.flash_fwd_launches
    o, lse = fa.flash_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_fwd_launches == before + 1
    assert o.dtype == qk_dt and lse.dtype == torch.float32
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, 128, 128)
    atol = 1e-4 if v_dt == torch.float32 else 4e-3
    np.testing.assert_allclose(o.float().cpu().numpy(), o_ref.float().cpu().numpy(), atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
def test_cuda_dispatch_launches_the_kernel(cuda):
    """flash_attention on CUDA tensors launches the kernel once (never the
    plain version), and its backward raises until the backward kernels
    are ported."""
    q, k, v = _qkv((1, 2, 200, 64), 81, cuda)
    before = fa.flash_fwd_launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_fwd_launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(),
                               fa.flash_fwd_cuda(q, k, v)[0].cpu().numpy(), atol=0)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        fa.flash_attention(q, k, v).sum().backward()


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 1, 64, 48), 82, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd_cuda(q, k, v)
    q, k, v = _qkv((1, 1, 64, 64), 82, cuda)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_cuda(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
