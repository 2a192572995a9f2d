"""Unmasked flash attention forward: the Hopper kernel and its plain version.

Layout (B, h, N, d) with q pre-scaled by 1/sqrt(d), as in the JAX package
(vaevar_tpu/ops/pallas_attn.py, vaevar_tpu/ops/flash.py). It carries the
full-grid LG stage of the 0.25 deg forecast model (N = 90*180 = 16200,
head dim 192), where dense logits would need N^2 floats per head.

- `flash_fwd_cuda`: launches csrc/flash_fwd.cu (built by ops/_build.py) on
  CUDA tensors; counts its launches in `flash_fwd_launches`.
- `flash_attention_plain`: the same function as blockwise online softmax in
  torch ops (vaevar_tpu/ops/flash.py:38-78); the CPU path and the kernel's
  reference on the card.
- `flash_attention`: the dispatch. CUDA tensors go to the kernel (or it
  raises); CPU tensors go to the plain version, which autograd
  differentiates as it is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: Launches of the CUDA kernel in this process (incremented per launch).
flash_fwd_launches = 0

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


@functools.cache
def _library():
    from vaevar_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q, k, v):
    """Launch the kernel on (B, h, N, d) CUDA tensors -> (O, lse)."""
    global flash_fwd_launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd_cuda: q, k, v must be on one CUDA device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_fwd_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; need equal (B, h, N, d)")
    B, h, N, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head dim {d} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or (q.dtype, v.dtype) not in _TYPE_PAIRS:
        raise ValueError(f"flash_fwd_cuda: dtypes q {q.dtype} k {k.dtype} "
                         f"v {v.dtype}; need q == k and (q, v) in {_TYPE_PAIRS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda: inputs must be contiguous")
    if B * h > 65535 or N >= 2**31 // d:
        raise ValueError(f"flash_fwd_cuda: B*h={B * h}, N={N} out of range")
    fn = _library()
    o = torch.empty_like(q)
    lse = torch.empty((B, h, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B * h, N, d, _TYPE_CODE[q.dtype],
             _TYPE_CODE[v.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (code {err})")
    flash_fwd_launches += 1
    return o, lse


class FlashAttention(torch.autograd.Function):
    """The kernel as an autograd node: forward only until the backward
    kernels (pallas_attn._dq_kernel/_dkv_kernel) are ported."""

    @staticmethod
    def forward(ctx, q, k, v):
        return flash_fwd_cuda(q, k, v)[0]

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError("flash backward kernels: ROADMAP B")


def flash_attention(q, k, v):
    """Unmasked attention on (B, h, N, d) with q pre-scaled; returns O."""
    if q.device.type == "cuda":
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)[0]
    raise ValueError(f"flash_attention: no path for device {q.device}")
