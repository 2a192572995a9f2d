"""Unmasked flash attention, forward and backward: the Hopper kernels and
their plain versions.

Layout (B, h, N, d) with q pre-scaled by 1/sqrt(d), as in the JAX package
(vaevar_tpu/ops/pallas_attn.py, vaevar_tpu/ops/flash.py). It carries the
full-grid LG stage of the 0.25 deg forecast model (N = 90*180 = 16200,
head dim 192), where dense logits would need N^2 floats per head.

- `flash_fwd_cuda`: launches csrc/flash_fwd.cu (built by ops/_build.py) on
  CUDA tensors; counts its launches in the counter `flash.fwd`
  (utils/trace.py).
- `flash_dq_cuda` / `flash_dkv_cuda`: launch the dq and dkv kernels of
  csrc/flash_bwd.cu; count them in `flash.dq` and `flash.dkv`.
  `flash_bwd_cuda` computes D and runs both.
- `flash_attention_plain`, `flash_dq_plain`, `flash_dkv_plain` and
  `flash_attention_bwd_plain`: the same functions blockwise in torch ops
  (vaevar_tpu/ops/flash.py:38-78 and pallas_attn.py:127-263); the CPU path
  and the kernels' references on the card.
- `FlashAttention`, the custom VJP of pallas_attn.py:269-305: its forward
  saves q, k, v, O and lse (O(N d) memory), its backward recomputes P from
  lse. CUDA tensors go to the kernels (or raise), CPU tensors to the plain
  versions; `flash_attention` applies it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vaevar_tpu_torch.utils import trace

HEAD_DIMS = (32, 64, 128, 192)
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TYPE_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16)}


def flash_attention_plain(q, k, v, block_q: int = 512, block_k: int = 1024):
    """Blockwise online-softmax attention -> (O (B, h, N, d), lse (B, h, N)).

    Logits, running max/sum and accumulator in f32; P rounded to v's dtype
    before P.V; O in q's dtype; lse = m + log(l) in f32. A ragged last block
    is sliced rather than padded and masked, which gives the same sums."""
    N = q.shape[2]
    outs, lses = [], []
    for qs in range(0, N, block_q):
        qb = q[:, :, qs:qs + block_q].float()
        m = torch.full(qb.shape[:-1], float("-inf"), device=q.device)
        l = torch.zeros(qb.shape[:-1], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        for ks in range(0, N, block_k):
            kb = k[:, :, ks:ks + block_k].float()
            vb = v[:, :, ks:ks + block_k]
            s = qb @ kb.transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(v.dtype).float() @ vb.float()
            m = m_new
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, 2), torch.cat(lses, 2)


def _bwd_rows(x, rows):
    return x[:, :, rows].float()


def flash_dq_plain(q, k, v, do, lse, delta, block_q: int = 1024, block_k: int = 1024):
    """dq of the flash-2 backward, blockwise, the math of _dq_kernel: per q
    block, over k blocks, P = exp(Q K^T - lse), dS = P (dO V^T - D), and
    dQ += dS K with dS rounded to k's dtype; sums in f32, dQ in q's dtype.
    lse and D = rowsum(dO * O) are (B, h, N) f32. A ragged last block is
    sliced rather than padded and masked."""
    N = q.shape[2]
    dq = torch.empty_like(q)
    for qs in range(0, N, block_q):
        rows = slice(qs, qs + block_q)
        qb, dob = _bwd_rows(q, rows), _bwd_rows(do, rows)
        lb, db = lse[:, :, rows, None], delta[:, :, rows, None]
        acc = torch.zeros(qb.shape, device=q.device)
        for ks in range(0, N, block_k):
            cols = slice(ks, ks + block_k)
            kb, vb = _bwd_rows(k, cols), _bwd_rows(v, cols)
            p = torch.exp(qb @ kb.transpose(-1, -2) - lb)
            ds = p * (dob @ vb.transpose(-1, -2) - db)
            acc += ds.to(k.dtype).float() @ kb
        dq[:, :, rows] = acc.to(q.dtype)
    return dq


def flash_dkv_plain(q, k, v, do, lse, delta, block_q: int = 1024, block_k: int = 1024):
    """(dk, dv) of the flash-2 backward, blockwise, the math of _dkv_kernel:
    per k block, over q blocks, P^T = exp(K Q^T - lse), dV += P^T dO with
    P^T rounded to dO's dtype, dS^T = P^T (V dO^T - D), dK += dS^T Q with
    dS^T rounded to q's dtype; sums in f32, dK in k's dtype, dV in v's."""
    N = q.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for ks in range(0, N, block_k):
        cols = slice(ks, ks + block_k)
        kb, vb = _bwd_rows(k, cols), _bwd_rows(v, cols)
        dk_acc = torch.zeros(kb.shape, device=q.device)
        dv_acc = torch.zeros(kb.shape, device=q.device)
        for qs in range(0, N, block_q):
            rows = slice(qs, qs + block_q)
            qb, dob = _bwd_rows(q, rows), _bwd_rows(do, rows)
            pt = torch.exp(kb @ qb.transpose(-1, -2) - lse[:, :, None, rows])
            dv_acc += pt.to(do.dtype).float() @ dob
            dst = pt * (vb @ dob.transpose(-1, -2) - delta[:, :, None, rows])
            dk_acc += dst.to(q.dtype).float() @ qb
        dk[:, :, cols] = dk_acc.to(k.dtype)
        dv[:, :, cols] = dv_acc.to(v.dtype)
    return dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, block_q: int = 1024,
                              block_k: int = 1024):
    """The flash-2 backward of _bwd_call -> (dq, dk, dv): D = rowsum(dO * O)
    in f32, then the plain versions of the dq and dkv kernels."""
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq_plain(q, k, v, do, lse, delta, block_q, block_k)
    return (dq, *flash_dkv_plain(q, k, v, do, lse, delta, block_q, block_k))


@functools.cache
def _fwd_fn():
    from vaevar_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fns():
    from vaevar_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = ctypes.c_int
    return lib.flash_bwd_dq, lib.flash_bwd_dkv


def _check(name, q, k, v, *same):
    """Device, shape, dtype and layout checks shared by the wrappers; `same`
    are further (B, h, N, d) tensors that take q's dtype."""
    ts = (q, k, v, *same)
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError(f"{name}: inputs must be on one CUDA device")
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]}; "
                         "need equal (B, h, N, d)")
    B, h, N, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if any(t.dtype != q.dtype for t in (k, *same)) or (q.dtype, v.dtype) not in _TYPE_PAIRS:
        raise ValueError(f"{name}: dtypes {[t.dtype for t in ts]}; need q's for "
                         f"all but v, and (q, v) in {_TYPE_PAIRS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: inputs must be 16-byte aligned "
                         "(the kernels copy 16 bytes at a time)")
    if B * h > 65535 or N >= 2**31 // d:
        raise ValueError(f"{name}: B*h={B * h}, N={N} out of range")
    return B, h, N, d


def flash_fwd_cuda(q, k, v):
    """Launch the forward kernel on (B, h, N, d) CUDA tensors -> (O, lse)."""
    B, h, N, d = _check("flash_fwd_cuda", q, k, v)
    fn = _fwd_fn()
    o = torch.empty_like(q)
    lse = torch.empty((B, h, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B * h, N, d, _TYPE_CODE[q.dtype],
             _TYPE_CODE[v.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (code {err})")
    trace.count("flash.fwd")
    return o, lse


def _check_rows(name, q, *rows):
    """lse and D: contiguous (B, h, N) float32 beside q."""
    if any(t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device
           or not t.is_contiguous() for t in rows):
        raise ValueError(f"{name}: lse/D {[(tuple(t.shape), t.dtype) for t in rows]}; "
                         "need contiguous (B, h, N) float32 beside q")


def flash_dq_cuda(q, k, v, do, lse, delta):
    """Launch the dq kernel on (B, h, N, d) CUDA tensors, with lse and
    D = rowsum(dO * O) (B, h, N) f32 -> dq."""
    B, h, N, d = _check("flash_dq_cuda", q, k, v, do)
    _check_rows("flash_dq_cuda", q, lse, delta)
    fn = _bwd_fns()[0]
    dq = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), B * h, N, d, _TYPE_CODE[q.dtype],
             _TYPE_CODE[v.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dq kernel launch failed (code {err})")
    trace.count("flash.dq")
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta):
    """Launch the dkv kernel on (B, h, N, d) CUDA tensors, with lse and D
    (B, h, N) f32 -> (dk, dv)."""
    B, h, N, d = _check("flash_dkv_cuda", q, k, v, do)
    _check_rows("flash_dkv_cuda", q, lse, delta)
    fn = _bwd_fns()[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * h, N, d,
             _TYPE_CODE[q.dtype], _TYPE_CODE[v.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed (code {err})")
    trace.count("flash.dkv")
    return dk, dv


def flash_bwd_cuda(q, k, v, o, lse, do):
    """The backward on CUDA tensors -> (dq, dk, dv): D = rowsum(dO * O) in
    f32 (one torch expression, outside the kernels as in _bwd_call), then
    the dq and dkv kernels."""
    _check("flash_bwd_cuda", q, k, v, o, do)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq_cuda(q, k, v, do, lse, delta)
    return (dq, *flash_dkv_cuda(q, k, v, do, lse, delta))


class FlashAttention(torch.autograd.Function):
    """The custom VJP: the forward keeps q, k, v, O and lse; the backward
    computes D and runs the dq and dkv kernels on CUDA tensors, their plain
    version on CPU tensors. Both forwards are deterministic, so a block
    recomputed under activation checkpointing gives the same O and lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda:
            o, lse = flash_fwd_cuda(q, k, v)
        else:
            o, lse = flash_attention_plain(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()
        if q.is_cuda:
            return flash_bwd_cuda(q, k, v, o, lse, do)
        return flash_attention_bwd_plain(q, k, v, o, lse, do)


class NoForwardADError(RuntimeError):
    """Flash attention was called under a forward-mode transform
    (torch.func.jvp): FlashAttention has no jvp rule, as the reference's
    custom VJP has none."""


def flash_attention(q, k, v):
    """Unmasked attention on (B, h, N, d) with q pre-scaled; returns O."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no path for device {q.device}")
    try:
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
    except RuntimeError as e:
        # torch.func refuses an autograd.Function without setup_context
        if "setup_context" in str(e):
            raise NoForwardADError("flash attention has no forward-mode (jvp) rule") from e
        raise
