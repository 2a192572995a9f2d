"""The CUDA flash kernels (forward, dq and dkv) against their plain
versions, on the card.

These tests need a CUDA device and skip without one. The file imports no JAX,
so it also runs on a machine without it; tests/conftest.py imports JAX, so
there run it with

    python -m pytest --noconftest -q -m gpu tests/test_torch_flash_card.py

Tolerances: atol 1e-4 in f32 (the kernel and the plain version sum in
another order). With bf16 v, 4e-3: P is rounded to bf16 before P.V, and a
P entry whose f32 logit differs by round-off can round to the neighbouring
bf16 value (2^-8 relative), which moves O by up to 2^-8 * p * |v|; a bf16
O also rounds (half an ulp at |O| < 1 is 2e-3). lse is f32 on both sides.

Backward, against flash_attention_bwd_plain on the same inputs, on the scale
of each gradient (max |plain|): 2e-5 for an f32 gradient (the sums over up
to 16200 terms run in another order); 2^-7 for a bf16 one (dv with bf16 v,
and all three in bf16): a rounded dS or P entry, or the output, can land
one bf16 ulp apart where f32 noise crosses a rounding boundary.
"""

import numpy as np
import pytest
import torch

from vaevar_tpu_torch.ops import flash_attn as fa
from vaevar_tpu_torch.utils import trace


def _launches():
    """The flash kernels' launch counters (fwd, dq, dkv) of this process."""
    c = trace.counters()
    return tuple(c.get(f"flash.{k}", 0) for k in ("fwd", "dq", "dkv"))


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


# Every head dim the kernels take, each (q/k, v) type pair, and ragged N:
# the kernels tile N by 32 and 64 rows (and dq's q rows by 128 where it runs
# 8 warps); the last 64-row tile holds 2, 1, 44, 33 and 1 rows, the last
# 32-row tile 2, 1, 12, 1 and 1 (N = 32 k + 1 and 64 k + 1 among them).
TYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16")]
SMALL_SHAPES = [(1, 1, 130), (1, 3, 257), (2, 2, 300), (1, 2, 161), (1, 1, 321)]
CASES = [((*bhn, d), dtypes) for d in fa.HEAD_DIMS for bhn in SMALL_SHAPES
         for dtypes in TYPE_PAIRS]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", CASES)
def test_kernel_matches_plain(cuda, shape, dtypes):
    qk_dt, v_dt = (getattr(torch, n) for n in dtypes)
    q, k, v = _qkv(shape, 80, cuda, qk_dt, v_dt)
    before = _launches()
    o, lse = fa.flash_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _launches()[0] == before[0] + 1
    assert o.dtype == qk_dt and lse.dtype == torch.float32
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, 128, 128)
    atol = 1e-4 if v_dt == torch.float32 else 4e-3
    np.testing.assert_allclose(o.float().cpu().numpy(), o_ref.float().cpu().numpy(), atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
def test_cuda_dispatch_launches_the_kernel(cuda):
    """flash_attention on CUDA tensors launches the forward kernel once
    (never the plain version), and its backward the dq and dkv kernels once
    each, with the gradients of flash_bwd_cuda."""
    q, k, v = _qkv((1, 2, 200, 64), 81, cuda)
    before = _launches()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _launches()[0] == before[0] + 1
    np.testing.assert_allclose(out.cpu().numpy(),
                               fa.flash_fwd_cuda(q, k, v)[0].cpu().numpy(), atol=0)
    for t in (q, k, v):
        t.requires_grad_(True)
    g = torch.randn_like(q)
    (fa.flash_attention(q, k, v) * g).sum().backward()
    torch.cuda.synchronize()
    assert _launches()[1:] == (before[1] + 1, before[2] + 1)
    o, lse = fa.flash_fwd_cuda(q.detach(), k.detach(), v.detach())
    want = fa.flash_bwd_cuda(q.detach(), k.detach(), v.detach(), o, lse, g)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


BWD_CASES = CASES + [((1, 2, 200, 32), ("float32", "float32")),
                     ((1, 6, 16200, 192), ("float32", "bfloat16")),
                     ((1, 6, 16200, 192), ("bfloat16", "bfloat16"))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", BWD_CASES)
def test_backward_kernels_match_plain(cuda, shape, dtypes):
    qk_dt, v_dt = (getattr(torch, n) for n in dtypes)
    q, k, v = _qkv(shape, 83, cuda, qk_dt, v_dt)
    do = torch.from_numpy(np.random.default_rng(84).standard_normal(
        shape, dtype=np.float32)).to(cuda, qk_dt)
    o, lse = fa.flash_fwd_cuda(q, k, v)
    before = _launches()
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _launches()[1:] == (before[1] + 1, before[2] + 1)
    assert [t.dtype for t in got] == [qk_dt, qk_dt, v_dt]
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, a, b in zip("qkv", got, want):
        tol = 2 ** -7 if a.dtype == torch.bfloat16 else 2e-5
        b = b.float()
        err = (a.float() - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", TYPE_PAIRS)
def test_backward_kernels_repeat_bitwise(cuda, dtypes):
    """No atomics: two launches of the forward (a block recomputed under
    remat) and of the backward on the same inputs give the same bits."""
    shape = (1, 6, 2000, 192)
    q, k, v = _qkv(shape, 85, cuda, *(getattr(torch, n) for n in dtypes))
    o, lse = fa.flash_fwd_cuda(q, k, v)
    o2, lse2 = fa.flash_fwd_cuda(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.randn_like(q)
    first = fa.flash_bwd_cuda(q, k, v, o, lse, do)
    second = fa.flash_bwd_cuda(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 4e-3)])
def test_library_yardstick_computes_the_kernels_function(cuda, dtype, atol):
    """The one PyTorch call that chip_smoke.py times beside the forward
    kernel (efficient attention in f32, flash attention in bf16) gives the
    kernel's O and lse: O within the file's atol for the type, lse 1e-4 in
    f32 and 4e-3 in bf16 (the library rounds its bf16 logits otherwise)."""
    import chip_smoke

    dt = getattr(torch, dtype)
    q, k, v = _qkv((1, 2, 300, 192), 86, cuda, dt, dt)
    o, lse = fa.flash_fwd_cuda(q, k, v)
    o_lib, lse_lib = chip_smoke.library_fwd(q, k, v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o_lib.float().cpu().numpy(), o.float().cpu().numpy(), atol=atol)
    np.testing.assert_allclose(lse_lib.cpu().numpy(), lse.cpu().numpy(), atol=atol)


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
    flat = torch.zeros(64 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_fwd_cuda(*(flat[1:].view(1, 1, 64, 64) for _ in range(3)))
    lse = torch.zeros(1, 1, 64, device=cuda)
    q, k, v = _qkv((1, 1, 64, 48), 82, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_bwd_cuda(q, k, v, q, lse, q)
    q, k, v = _qkv((1, 1, 64, 64), 82, cuda)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_bwd_cuda(q, k, v, q, lse, q.bfloat16())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_cuda(q, k, v, q, lse.double(), q)
