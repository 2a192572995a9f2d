"""The numerics the tensor-core flash kernels rest on, emulated on the CPU.

The kernels in vaevar_tpu_torch/csrc multiply f32 operands on TF32 tensor
cores with the split-TF32 product (3xTF32, mma_sm90.cuh): x = hi + lo with
hi = tf32(x), lo = x - hi, and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b in
f32. Here `tf32` rounds to 10 mantissa bits, to nearest with ties away from
zero, as `cvt.rna.tf32.f32` does; the tensor core reads lo's top 19 bits,
which `tf32_trunc` emulates; and the products of TF32 values run in f32 as
the tensor core runs them (11 x 11 significant bits are exact in f32). With every f32 product done that way, the dense flash forward and
backward meet the card tolerances against the f32 plain versions
(ops/flash_attn.py): O and lse atol 1e-4, gradients 2e-5 x max |ref|. A
single TF32 pass misses them: the tests assert each miss, so a kernel that
dropped the split would fail those tolerances on the card.

The dq kernel's own recipe with the main path's types (f32 q, k and dO, bf16
v) is emulated too: dO.V^T in two passes (bf16 v is exact in TF32, so its lo
is 0) and dS.K summed tile by tile (32 keys) in fresh f32 partial sums. It
meets the dq tolerance; dropping dO's lo pass as well misses it.
"""

import numpy as np
import pytest
import torch

from vaevar_tpu_torch.ops import flash_attn as fa

O_TOL, LSE_TOL, GRAD_TOL = 1e-4, 1e-4, 2e-5


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """x truncated to TF32: what the tensor core reads of an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    return tf32_trunc(a - a_hi) @ b_hi + a_hi @ tf32_trunc(b - b_hi) + a_hi @ b_hi


def forward(q, k, v, mm):
    """Dense softmax attention with lse, every product through `mm`."""
    s = mm(q, k.mT)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l))[..., 0]


def backward(q, k, v, o, lse, do, mm):
    """The flash-2 backward from the forward's O and lse, products through
    `mm`: P = exp(Q.K^T - lse), dS = P (dO.V^T - D), dQ = dS.K,
    dK = dS^T.Q, dV = P^T.dO."""
    p = torch.exp(mm(q, k.mT) - lse[..., None])
    ds = p * (mm(do, v.mT) - (do * o).sum(-1, keepdim=True))
    return mm(ds, k), mm(ds.mT, q), mm(p.mT, do)


def _errors(shape, mm):
    """Max errors of the emulated forward and backward against the f32 plain
    versions: O and lse absolute, gradients over max |ref|."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   for _ in range(4))
    q = q * shape[-1] ** -0.5
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v)
    o, lse = forward(q, k, v, mm)
    errs = {"o": (o - o_ref).abs().max().item(), "lse": (lse - lse_ref).abs().max().item()}
    want = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do)
    got = backward(q, k, v, o_ref, lse_ref, do, mm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
    return errs


TOLS = {"o": O_TOL, "lse": LSE_TOL, "dq": GRAD_TOL, "dk": GRAD_TOL, "dv": GRAD_TOL}
# Observed single-pass errors (seed 7): O 3.6e-4 and 1.4e-4, gradients
# 5.5e-4 to 9.7e-4 of their max (N = 300, 1000); lse 1.7e-4 at N = 300 but
# 1.13e-4 at N = 1000, too close to 1e-4 to assert, so its miss is asserted
# at N = 300 only. 3xTF32: O <= 7.8e-7, lse <= 9.6e-7, gradients <= 3.1e-6.
SINGLE_PASS_MISSES = {300: {"o", "lse", "dq", "dk", "dv"}, 1000: {"o", "dq", "dk", "dv"}}


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -11, -(one + 2 ** -11),
                      one + 2 ** -10 - 2 ** -23, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, one, one + 2 ** -9, -(one + 2 ** -10), one + 2 ** -10,
                         0.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(tf32_trunc(x)[:4], torch.tensor([one, one, one + 2 ** -10, -one]))
    # hi + lo, as the tensor core reads them, recovers x to 2^-21 relative
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(1000, dtype=np.float32))
    hi = tf32(y)
    rel = ((hi + tf32_trunc(y - hi) - y).abs() / y.abs()).max().item()
    assert rel <= 2 ** -21


@pytest.mark.parametrize("n", [300, 1000])
def test_3xtf32_meets_the_card_tolerances(n):
    errs = _errors((1, 2, n, 192), mm_3xtf32)
    for name, err in errs.items():
        assert err <= TOLS[name], (name, err)


@pytest.mark.parametrize("n", [300, 1000])
def test_single_tf32_pass_misses_the_card_tolerances(n):
    errs = _errors((1, 2, n, 192), mm_1xtf32)
    missed = {name for name, err in errs.items() if err > TOLS[name]}
    assert SINGLE_PASS_MISSES[n] <= missed, errs


def mm_b_exact(a, b):
    """a.b with b exact in TF32 (bf16 values): the lo_a.b and hi_a.b passes."""
    a_hi = tf32(a)
    return tf32_trunc(a - a_hi) @ b + a_hi @ b


def dq_kernel_recipe(q, k, v, do, lse, delta, do_exact=False, tile=32):
    """dq as csrc/flash_bwd.cu computes it with f32 q, k, dO and v holding
    bf16 values: per `tile` keys, S = Q.K^T on 3xTF32, dP = dO.V^T in two
    passes, dS = P (dP - D), and dS.K on 3xTF32 in a fresh partial sum added
    to dQ in f32. do_exact: dO.V^T in one pass, as if dO were exact in TF32."""
    acc = torch.zeros_like(q)
    for ks in range(0, q.shape[-2], tile):
        kb, vb = k[..., ks:ks + tile, :], v[..., ks:ks + tile, :]
        p = torch.exp(mm_3xtf32(q, kb.mT) - lse[..., None])
        dp = tf32(do) @ vb.mT if do_exact else mm_b_exact(do, vb.mT)
        acc = acc + mm_3xtf32(p * (dp - delta[..., None]), kb)
    return acc


def _dq_error(n, do_exact):
    """max |dq - flash_dq_plain| / max |ref| of the emulated recipe at
    (1, 2, n, 192), with bf16 v, lse and D from the plain forward."""
    shape = (1, 2, n, 192)
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   for _ in range(4))
    q, v = q * shape[-1] ** -0.5, v.bfloat16()
    o, lse = fa.flash_attention_plain(q, k, v)
    delta = (do * o).sum(-1)
    want = fa.flash_dq_plain(q, k, v, do, lse, delta)
    got = dq_kernel_recipe(q, k, v.float(), do, lse, delta, do_exact)
    return ((got - want).abs().max() / want.abs().max()).item()


# Observed (seed 7): the recipe 1.76e-6 (N = 300) and 2.92e-6 (N = 1000) of
# max |ref|; with dO's lo pass dropped 3.17e-4 and 2.89e-4, a miss of ~15x at
# both sizes (seeds 8 and 9: 2.4e-4 to 4.9e-4).
DO_EXACT_MISSES = {300: 3.17e-4, 1000: 2.89e-4}


@pytest.mark.parametrize("n", [300, 1000])
def test_dq_kernel_recipe_meets_the_card_tolerance(n):
    err = _dq_error(n, do_exact=False)
    assert err <= GRAD_TOL, err


@pytest.mark.parametrize("n", sorted(DO_EXACT_MISSES))
def test_dq_without_the_lo_pass_of_do_misses_the_card_tolerance(n):
    err = _dq_error(n, do_exact=True)
    assert err > GRAD_TOL, err
