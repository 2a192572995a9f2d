"""Multi-head attention cores for windowed attention.

Port of vaevar_tpu/ops/attention.py:20-51. `dense_attention` serves the
small Swin windows; `window_attention_core` sends unmasked windows of at
least `flash_min_seq` tokens (the full-grid LG stage) to flash attention.
"""

from __future__ import annotations

import torch

from vaevar_tpu_torch.ops.flash_attn import flash_attention


def matmul(a, b):
    """a @ b after promoting both to their common dtype (jnp.einsum's rule;
    torch.matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def dense_attention(q, k, v, mask=None):
    """q, k, v: (B, h, N, d); mask: (nW, N, N) additive or None.

    Logits and softmax in f32, weights cast to q's dtype, then P.V. With a
    mask, B is a multiple of nW in window_partition order."""
    logits = q.float() @ k.float().transpose(-1, -2)
    if mask is not None:
        nW = mask.shape[0]
        B, h, N, _ = logits.shape
        logits = (logits.reshape(B // nW, nW, h, N, N)
                  + mask[None, :, None].float()).reshape(B, h, N, N)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return matmul(w, v)


def window_attention_core(q, k, v, mask=None, flash_min_seq: int = 4096):
    """Dense or flash on the static window length (q pre-scaled)."""
    if mask is None and q.shape[2] >= flash_min_seq:
        return flash_attention(q, k, v)
    return dense_attention(q, k, v, mask)
