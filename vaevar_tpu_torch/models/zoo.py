"""Layer zoo: the reference's auxiliary attention, MLP and block variants.

Port of vaevar_tpu/models/zoo.py, module for module and in its order:
channel-last (NHWC) like the JAX package, deterministic (every shipped drop
rate is 0), with flax's numerics: LayerNorm eps 1e-6, exact GELU,
`nn.avg_pool` as VALID pooling with stride equal to the window, SAME
padding on the depthwise 3x3 conv and VALID after `periodic_pad2d`. None of
these modules is used by the shipped LGUnet configs.

Each submodule and parameter keeps its flax name, so the JAX package's
weights cross over through utils/port_jax.py::zoo_state_dict_from_flax.
Where flax infers an input width from the first call, the port takes it
from the module's `dim` (a zoo module is called on inputs of `dim`
channels); `GatedMlp` also takes the spatial `resolution` its (H*W, H*W)
mixing layer needs. Parameters start from flax's initialisers (Dense
kernels N(0, 0.02^2) truncated at 2 std, convs lecun_normal, biases zero),
drawn from torch's generator. The MoE modules take the router's jitter as
an explicit `rng` (a torch.Generator) where flax takes a "moe" rng stream;
without one they route deterministically, as flax's `deterministic=True`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vaevar_tpu_torch.models.init import lecun_std
from vaevar_tpu_torch.models.lgunet import dense, layer_norm, torch_dtype
from vaevar_tpu_torch.ops import moe as moe_ops
from vaevar_tpu_torch.ops import rope as rope_ops
from vaevar_tpu_torch.ops import windows as win_ops
from vaevar_tpu_torch.ops.attention import dense_attention, matmul
from vaevar_tpu_torch.ops.posenc import relative_position_index


def _trunc02(t):
    return nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04)


@torch.no_grad()
def _linear(d_in, d_out):
    """nn.Linear with flax `_dense`'s initialisers."""
    lin = nn.Linear(d_in, d_out)
    _trunc02(lin.weight)
    lin.bias.zero_()
    return lin


@torch.no_grad()
def _conv(d_in, d_out, kernel, groups=1, padding=0):
    """nn.Conv2d with flax nn.Conv's initialisers (lecun_normal over the
    kernel's fan-in kh * kw * d_in / groups, bias zero)."""
    conv = nn.Conv2d(d_in, d_out, kernel, padding=padding, groups=groups)
    std = lecun_std(kernel[0] * kernel[1] * d_in // groups)
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std)
    conv.bias.zero_()
    return conv


def _ln(dim):
    return nn.LayerNorm(dim, eps=1e-6)


def _conv_nhwc(x, conv, dtype=None):
    """flax nn.Conv on (B, H, W, C) with the module's padding and groups."""
    dt = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                 padding=conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def _avg_pool(x, window):
    """flax nn.avg_pool(x, window, window) on (B, H, W, C): VALID."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(window)).permute(0, 2, 3, 1)


def _heads(t, n, h):
    """(B, M, n * h * hd) -> n tensors (B, h, M, hd)."""
    B, M, _ = t.shape
    return t.reshape(B, M, n, h, -1).permute(2, 0, 3, 1, 4)


def _merge(t):
    """(B, h, M, hd) -> (B, M, h * hd)."""
    B, h, M, hd = t.shape
    return t.transpose(1, 2).reshape(B, M, h * hd)


def _tables(tables, device):
    return tuple(torch.from_numpy(t).to(device) for t in tables)


def periodic_pad2d(x, pad_hw):
    """Longitude-circular, latitude-zero padding of (B, H, W, C)."""
    ph, pw = pad_hw
    if pw:
        x = torch.cat([x[:, :, -pw:], x, x[:, :, :pw]], dim=2)
    if ph:
        x = F.pad(x, (0, 0, 0, 0, ph, ph))
    return x


def attn_norm(x, method: str = "softmax"):
    """softmax / squared-relu / softmax-plus attention normalizers."""
    if method == "softmax":
        return torch.softmax(x, dim=-1)
    if method == "squared_relu":
        return torch.relu(x) ** 2
    if method == "softmax_plus":
        n = x.shape[-1]
        mask = (x > -math.inf).to(x.dtype)
        scale = np.log(n) / np.log(512) * mask + (1 - mask)
        return torch.softmax(x * scale, dim=-1)
    raise ValueError(method)


class ScaleOffset(nn.Module):
    """Per-channel learned scale (init N(0, 0.02^2)) and offset."""

    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(0.02 * torch.randn(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return x * self.gamma + self.beta


class SEBlock(nn.Module):
    """Squeeze-excite channel attention over (B, H, W, C)."""

    def __init__(self, dim, reduction=4, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.fc1 = _linear(dim, dim // reduction)
        self.fc2 = _linear(dim // reduction, dim)

    def forward(self, x):
        y = x.mean(dim=(1, 2), keepdim=True)
        y = dense(torch.relu(dense(y, self.fc1, self.dtype)), self.fc2, self.dtype)
        return x * torch.sigmoid(y)


class RelativePositionalBias(nn.Module):
    """Additive (N, N) bias from a learned table for an n-D window; call on
    logits (..., nH, N, N)."""

    def __init__(self, window_size, num_heads=1):
        super().__init__()
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        T = math.prod(2 * s - 1 for s in self.window_size)
        self.table = nn.Parameter(_trunc02(torch.empty(T, num_heads)))
        self.register_buffer(
            "rel_index", torch.from_numpy(relative_position_index(self.window_size).reshape(-1)),
            persistent=False)

    def forward(self, logits):
        N = math.prod(self.window_size)
        bias = self.table.float()[self.rel_index].reshape(N, N, self.num_heads)
        return logits + bias.permute(2, 0, 1)


# --- attention variants -------------------------------------------------------


class CrossAttention(nn.Module):
    """x attends to window-avg-pooled y."""

    def __init__(self, dim, window_size, num_heads, dtype=None):
        super().__init__()
        self.window_size, self.num_heads, self.dtype = window_size, num_heads, torch_dtype(dtype)
        self.l_q = _linear(dim, dim)
        self.l_kv = _linear(dim, 2 * dim)
        self.l_proj = _linear(dim, dim)

    def forward(self, x, y):
        B, H, W, C = x.shape
        h = self.num_heads
        q = _heads(dense(x.reshape(B, H * W, C), self.l_q, self.dtype), 1, h)[0]
        kv = dense(_avg_pool(y, self.window_size).reshape(B, -1, C), self.l_kv, self.dtype)
        k, v = _heads(kv, 2, h)
        out = _merge(dense_attention(q * (C // h) ** -0.5, k, v)).reshape(B, H, W, C)
        return dense(out, self.l_proj, self.dtype)


class _WindowCore(nn.Module):
    """Shared windowed rope attention over pre-projected qkv chunks
    (no parameters)."""

    def __init__(self, window_size, num_heads):
        super().__init__()
        self.window_size, self.num_heads = tuple(window_size), num_heads

    def forward(self, qkv, shift, resolution):
        H, W = resolution
        win = self.window_size
        h = self.num_heads
        hd = qkv.shape[-1] // 3 // h
        mask = None
        if shift[0] or shift[1]:
            qkv = win_ops.shift2d(qkv, -shift[0], -shift[1])
            m = win_ops.swin_attention_mask(H, W, win, shift, neg=-100.0)
            mask = None if m is None else torch.from_numpy(m).to(qkv.device)
        qkvw = win_ops.window_partition(qkv, win)  # (B*nW, N, 3C)
        q, k, v = _heads(qkvw, 3, h)
        tables = _tables(rope_ops.rope2_tables(win, hd), qkv.device)
        q = rope_ops.apply_rope2(q, tables) * hd ** -0.5
        k = rope_ops.apply_rope2(k, tables)
        x = win_ops.window_reverse(_merge(dense_attention(q, k, v, mask)), win, H, W)
        if shift[0] or shift[1]:
            x = win_ops.shift2d(x, shift[0], shift[1])
        return x


class ConvAttention(nn.Module):
    """4-branch window attention: qkv split into 4 chunks, each attending
    with a different shift (none / lon / lat / both), concatenated.
    head_dim = dim // heads // 4."""

    def __init__(self, dim, window_size, num_heads, dtype=None):
        super().__init__()
        self.window_size, self.dtype = tuple(window_size), torch_dtype(dtype)
        self.qkv = _linear(dim, 3 * dim)
        self.branches = nn.ModuleList(_WindowCore(window_size, num_heads) for _ in range(4))
        self.proj = _linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        wh, ww = self.window_size
        chunks = torch.chunk(dense(x, self.qkv, self.dtype), 4, dim=-1)
        shifts = [(0, 0), (0, ww // 2), (wh // 2, 0), (wh // 2, ww // 2)]
        outs = [core(chunk, shift, (H, W))
                for core, chunk, shift in zip(self.branches, chunks, shifts)]
        return dense(torch.cat(outs, dim=-1), self.proj, self.dtype)


class DilatedAttention(nn.Module):
    """Window attention over dilated token grids: tokens are grouped by
    residue modulo `dilated_size` inside a total window, so each window spans
    window_size * dilated_size cells."""

    def __init__(self, dim, window_size, num_heads, dilated_size=(1, 1), dtype=None):
        super().__init__()
        self.window_size, self.dilated_size = tuple(window_size), tuple(dilated_size)
        self.num_heads, self.dtype = num_heads, torch_dtype(dtype)
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        wh, ww = self.window_size
        dh, dw = self.dilated_size
        hd = C // self.num_heads
        x = x.reshape(B, H // (wh * dh), wh, dh, W // (ww * dw), ww, dw, C)
        x = x.permute(0, 1, 4, 3, 6, 2, 5, 7).reshape(-1, wh * ww, C)
        q, k, v = _heads(dense(x, self.qkv, self.dtype), 3, self.num_heads)
        tables = _tables(rope_ops.rope2_tables(self.window_size, hd), x.device)
        q = rope_ops.apply_rope2(q, tables) * hd ** -0.5
        k = rope_ops.apply_rope2(k, tables)
        out = _merge(dense_attention(q, k, v)).reshape(
            B, H // (wh * dh), W // (ww * dw), dh, dw, wh, ww, C)
        out = out.permute(0, 1, 5, 3, 2, 6, 4, 7).reshape(B, H, W, C)
        return dense(out, self.proj, self.dtype)


class GAUAttention(nn.Module):
    """Gated attention unit: a quadratic window branch and, with
    attn_type="lin", a linear global branch, from a shared s-dim base with
    per-branch ScaleOffset; squared-relu attention with a relative position
    bias; silu-gated output u * (quad + lin)."""

    def __init__(self, dim, window_size, expansion_factor=2, s=128, attn_type="lin",
                 lin_rope_shape=(32, 64), dtype=None):
        super().__init__()
        self.window_size, self.s, self.attn_type = tuple(window_size), s, attn_type
        self.hidden = expansion_factor * dim
        self.dtype = torch_dtype(dtype)
        self.uv = _linear(dim, 2 * self.hidden + s)
        self.quad_q, self.quad_k = ScaleOffset(s), ScaleOffset(s)
        self.rel_bias = RelativePositionalBias(window_size, 1)
        if attn_type == "lin":
            self.lin_q, self.lin_k = ScaleOffset(s), ScaleOffset(s)
        self.proj = _linear(self.hidden, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        win, s, hidden = self.window_size, self.s, self.hidden
        N = win[0] * win[1]
        xw = win_ops.window_partition(x, win)  # (B*nW, N, C)
        B_ = xw.shape[0]
        nW = B_ // B
        uvb = F.silu(dense(xw, self.uv, self.dtype))
        u, v, base = torch.split(uvb, [hidden, hidden, s], dim=-1)
        tables = _tables(rope_ops.rope2_tables(win, s), x.device)
        quad_q = rope_ops.apply_rope2(self.quad_q(base), tables) / N
        quad_k = rope_ops.apply_rope2(self.quad_k(base), tables)
        logits = quad_q.float() @ quad_k.float().transpose(-1, -2)
        logits = self.rel_bias(logits.reshape(B_, 1, N, N)).reshape(B_, N, N)
        out = matmul(attn_norm(logits, "squared_relu").to(v.dtype), v)
        if self.attn_type == "lin":
            # rope over the full grid, not the window
            grid_tables = _tables(rope_ops.rope2_tables((H, W), s), x.device)

            def rot(t):
                t = win_ops.window_reverse(t, win, H, W).reshape(B, H * W, -1)
                return win_ops.window_partition(
                    rope_ops.apply_rope2(t, grid_tables).reshape(B, H, W, -1), win)

            lin_q, lin_k = rot(self.lin_q(base)), rot(self.lin_k(base))
            lin_kv = lin_k.reshape(B, nW * N, s).float().transpose(1, 2) @ (
                v.reshape(B, nW * N, hidden) / (N * nW)).float()
            lin = matmul(lin_q.reshape(B, nW * N, s), lin_kv.to(v.dtype))
            out = out + lin.reshape(B_, N, hidden)
        y = dense(u * out, self.proj, self.dtype)
        return win_ops.window_reverse(y, win, H, W)


class HydraAttention(nn.Module):
    """Window attention (local windows, or with local=False the tokens at one
    in-window position across windows), or with use_attn=False the hydra
    branch: a normalized global k*v aggregate gating the normalized q."""

    def __init__(self, dim, window_size, num_heads, local=True, use_attn=True, dtype=None):
        super().__init__()
        self.window_size, self.num_heads = tuple(window_size), num_heads
        self.local, self.use_attn, self.dtype = local, use_attn, torch_dtype(dtype)
        if use_attn:
            self.qkv = _linear(dim, 3 * dim)
        else:
            self.kv = _linear(dim, 2 * dim)
            self.q = _linear(dim, dim)
        self.proj = _linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        win = self.window_size
        N = win[0] * win[1]
        hd = C // self.num_heads
        if self.use_attn:
            xw = win_ops.window_partition(x, win)  # (B*nW, N, C)
            nW = xw.shape[0] // B
            if not self.local:
                xw = xw.reshape(B, nW, N, C).transpose(1, 2).reshape(B * N, nW, C)
            q, k, v = _heads(dense(xw, self.qkv, self.dtype), 3, self.num_heads)
            if self.local:
                tables = _tables(rope_ops.rope2_tables(win, hd), x.device)
                q = rope_ops.apply_rope2(q, tables)
                k = rope_ops.apply_rope2(k, tables)
            out = _merge(dense_attention(q * hd ** -0.5, k, v))
            if not self.local:
                out = out.reshape(B, N, nW, C).transpose(1, 2).reshape(B * nW, N, C)
            y = win_ops.window_reverse(out, win, H, W)
        else:
            k, v = torch.chunk(dense(x, self.kv, self.dtype), 2, dim=-1)
            k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
            hy_kv = (k * v).reshape(B, -1, C).sum(dim=-2, keepdim=True)
            q = dense(x, self.q, self.dtype).reshape(B, -1, C)
            q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
            y = (q * hy_kv).reshape(B, H, W, C)
        return dense(y, self.proj, self.dtype)


class HiLoAttention(nn.Module):
    """Hi-Fi local window heads and Lo-Fi pooled-kv global heads,
    concatenated Lo-Fi first; alpha is the fraction of Lo-Fi heads."""

    def __init__(self, dim, num_heads, window_size=(2, 2), alpha=0.5, dtype=None):
        super().__init__()
        self.window_size, self.dtype = tuple(window_size), torch_dtype(dtype)
        self.head_dim = dim // num_heads
        l_heads = int(num_heads * alpha)
        h_heads = num_heads - l_heads
        if self.window_size == (1, 1):
            l_heads, h_heads = num_heads, 0
        self.l_heads, self.h_heads = l_heads, h_heads
        l_dim, h_dim = l_heads * self.head_dim, h_heads * self.head_dim
        if h_heads > 0:
            self.h_qkv = _linear(dim, 3 * h_dim)
            self.h_proj = _linear(h_dim, h_dim)
        if l_heads > 0:
            self.l_q = _linear(dim, l_dim)
            self.l_kv = _linear(dim, 2 * l_dim)
            self.l_proj = _linear(l_dim, l_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        ws = self.window_size
        scale = self.head_dim ** -0.5
        outs = []
        if self.h_heads > 0:
            xw = win_ops.window_partition(x, ws)  # (B*nW, N, C)
            q, k, v = _heads(dense(xw, self.h_qkv, self.dtype), 3, self.h_heads)
            hifi = win_ops.window_reverse(_merge(dense_attention(q * scale, k, v)), ws, H, W)
            outs.append(dense(hifi, self.h_proj, self.dtype))
        if self.l_heads > 0:
            q = _heads(dense(x.reshape(B, H * W, C), self.l_q, self.dtype), 1, self.l_heads)[0]
            src = _avg_pool(x, ws) if max(ws) > 1 else x
            k, v = _heads(dense(src.reshape(B, -1, C), self.l_kv, self.dtype), 2, self.l_heads)
            out = _merge(dense_attention(q * scale, k, v)).reshape(B, H, W, -1)
            outs.append(dense(out, self.l_proj, self.dtype))
        return outs[0] if len(outs) == 1 else torch.cat(outs[::-1], dim=-1)


# --- MoE layers ----------------------------------------------------------------


class MoEDense(nn.Module):
    """Top-1-routed bank of dense experts with capacity dropping.

    The bank is stacked parameters (E, in, out): every expert computes on
    every token and the combine zeroes the slots not routed (ops/moe.py).
    x and the router's input (`attr`, or x when attr is None) both have
    `attr_dim` channels, as in every zoo caller. Returns
    (y, z_loss, balance_loss)."""

    def __init__(self, features, num_experts, attr_dim, expert_capacity=1.0,
                 router_noise=1e-2, is_scale_prob=True, drop_tokens=True, act=None,
                 hidden=None, dtype=None):
        super().__init__()
        self.features, self.num_experts = features, num_experts
        self.expert_capacity, self.router_noise = expert_capacity, router_noise
        self.is_scale_prob, self.drop_tokens, self.act = is_scale_prob, drop_tokens, act
        hid = hidden or features
        self.router = _linear(attr_dim, num_experts)
        self.w1 = nn.Parameter(_trunc02(torch.empty(num_experts, attr_dim, hid)))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hid))
        if act is not None:
            self.w2 = nn.Parameter(_trunc02(torch.empty(num_experts, hid, features)))
            self.b2 = nn.Parameter(torch.zeros(num_experts, features))

    def forward(self, x, attr=None, rng=None):
        B, H, W, C = x.shape
        E = self.num_experts
        tokens = x.reshape(B, H * W, C)
        attr_t = tokens if attr is None else attr.reshape(B, H * W, -1)
        idx, probs, logits = moe_ops.top1_route(
            attr_t, lambda a: dense(a, self.router), rng, self.router_noise)
        z_loss = moe_ops.router_z_loss(logits)
        balance = moe_ops.load_balancing_loss(probs, idx, E)

        dt = torch.promote_types(tokens.dtype, self.w1.dtype)
        expert_out = torch.einsum("btc,ech->ebth", tokens.to(dt), self.w1.to(dt))
        expert_out = expert_out + self.b1[:, None, None]
        if self.act is not None:
            expert_out = torch.einsum("ebth,eho->ebto", self.act(expert_out), self.w2)
            expert_out = expert_out + self.b2[:, None, None]

        mask = moe_ops.capacity_mask(idx.reshape(-1), E, self.expert_capacity,
                                     self.drop_tokens)
        p_max = probs.amax(dim=-1).reshape(-1)
        y = moe_ops.moe_combine(expert_out.reshape(E, -1, expert_out.shape[-1]), mask, p_max,
                                tokens.reshape(-1, C), self.is_scale_prob)
        return y.reshape(B, H, W, self.features), z_loss, balance


class MoEMlp(nn.Module):
    """MLP with top-1 switch experts (exact-GELU expert MLPs)."""

    def __init__(self, dim, hidden, num_experts=4, expert_capacity=1.0, dtype=None):
        super().__init__()
        self.experts = MoEDense(dim, num_experts, dim, expert_capacity, act=F.gelu,
                                hidden=hidden, dtype=dtype)

    def forward(self, x, attr=None, rng=None):
        return self.experts(x, attr, rng)


class MoEWindowAttention(nn.Module):
    """SD-style window attention whose qkv and proj projections are top-1
    MoE banks. Returns (y, z_losses, balance_losses)."""

    def __init__(self, dim, window_size, num_heads, num_experts=4, shift_size=(0, 0),
                 dtype=None):
        super().__init__()
        self.shift_size = tuple(shift_size)
        self.qkv_moe = MoEDense(3 * dim, num_experts, dim, dtype=dtype)
        self.core = _WindowCore(window_size, num_heads)
        self.proj_moe = MoEDense(dim, num_experts, dim, dtype=dtype)

    def forward(self, x, attr=None, rng=None):
        B, H, W, C = x.shape
        qkv, z1, b1 = self.qkv_moe(x, attr, rng)
        core = self.core(qkv, self.shift_size, (H, W))
        y, z2, b2 = self.proj_moe(core, attr, rng)
        return y, z1 + z2, b1 + b2


# --- MLP zoo -------------------------------------------------------------------


class GluMlp(nn.Module):
    """GLU-gated MLP; sigmoid gate on the second half."""

    def __init__(self, dim, hidden, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.fc1 = _linear(dim, hidden)
        self.fc2 = _linear(hidden // 2, dim)

    def forward(self, x):
        val, gates = torch.chunk(dense(x, self.fc1, self.dtype), 2, dim=-1)
        return dense(val * torch.sigmoid(gates), self.fc2, self.dtype)


class GatedMlp(nn.Module):
    """gMLP spatial gating over (B, H, W, C) with (H, W) = `resolution`:
    split hidden, layernorm the gate half, mix it spatially with a learned
    (HW, HW) linear, multiply. Residual inside, as the reference."""

    def __init__(self, dim, resolution, hidden=None, get_weight=False, dtype=None):
        super().__init__()
        self.get_weight, self.dtype = get_weight, torch_dtype(dtype)
        hidden = hidden or (dim if get_weight else 2 * dim)
        gate = hidden if get_weight else hidden // 2
        hw = resolution[0] * resolution[1]
        self.norm = _ln(dim)
        self.fc1 = _linear(dim, hidden)
        self.norm1 = _ln(gate)
        self.spatial_fc = _linear(hw, hw)
        if not get_weight:
            self.fc2 = _linear(gate, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        y = F.gelu(dense(layer_norm(x, self.norm), self.fc1, self.dtype))
        u, v = (y, None) if self.get_weight else torch.chunk(y, 2, dim=-1)
        u = layer_norm(u, self.norm1).reshape(B, H * W, -1).transpose(1, 2)
        u = dense(u, self.spatial_fc, self.dtype).transpose(1, 2).reshape(B, H, W, -1)
        if self.get_weight:
            return u
        return dense((u + 1.0) * v, self.fc2, self.dtype) + x


class ConvMlp(nn.Module):
    """1x1-conv MLP as dense layers (fc1, relu, fc2)."""

    def __init__(self, dim, hidden, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.fc1 = _linear(dim, hidden)
        self.fc2 = _linear(hidden, dim)

    def forward(self, x):
        return dense(torch.relu(dense(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class MAGMlp(nn.Module):
    """Multi-axis gated MLP (MAXIM): channel-split into a local branch
    (windows) and a global branch (grid-strided windows), each through a
    GatedMlp, concatenated, with an outer residual."""

    def __init__(self, dim, window_size=(4, 8), dtype=None):
        super().__init__()
        self.window_size, self.dtype = tuple(window_size), torch_dtype(dtype)
        self.norm = _ln(dim)
        self.fc1 = _linear(dim, dim)
        self.local_gmlp = GatedMlp(dim // 2, self.window_size, dtype=dtype)
        self.global_gmlp = GatedMlp(dim // 2, self.window_size, dtype=dtype)
        self.fc2 = _linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        wh, ww = self.window_size
        y = F.gelu(dense(layer_norm(x, self.norm), self.fc1, self.dtype))
        lb, gb = torch.chunk(y, 2, dim=-1)
        lw = win_ops.window_partition(lb, (wh, ww)).reshape(-1, wh, ww, C // 2)
        lw = self.local_gmlp(lw)
        lb = win_ops.window_reverse(lw.reshape(-1, wh * ww, C // 2), (wh, ww), H, W)
        gh, gw = H // wh, W // ww
        gwnd = gb.reshape(B, wh, gh, ww, gw, C // 2).permute(0, 2, 4, 1, 3, 5)
        gwnd = self.global_gmlp(gwnd.reshape(-1, wh, ww, C // 2))
        gb = gwnd.reshape(B, gh, gw, wh, ww, C // 2).permute(0, 3, 1, 4, 2, 5)
        gb = gb.reshape(B, H, W, C // 2)
        return x + dense(torch.cat([lb, gb], dim=-1), self.fc2, self.dtype)


class RCAB(nn.Module):
    """Residual channel-attention block: norm -> periodic-pad 3x3 conv x2
    -> squeeze-excite -> residual."""

    def __init__(self, dim, reduction=4, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.norm = _ln(dim)
        self.conv1 = _conv(dim, dim, (3, 3))
        self.conv2 = _conv(dim, dim, (3, 3))
        self.se = SEBlock(dim, reduction, dtype)

    def forward(self, x):
        y = periodic_pad2d(layer_norm(x, self.norm), (1, 1))
        y = F.leaky_relu(_conv_nhwc(y, self.conv1, self.dtype))
        y = _conv_nhwc(periodic_pad2d(y, (1, 1)), self.conv2, self.dtype)
        return x + self.se(y)


class RDCAB(nn.Module):
    """Residual dense channel-attention block: norm -> MLP -> SE -> residual."""

    def __init__(self, dim, reduction=4, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.norm = _ln(dim)
        self.fc1 = _linear(dim, dim)
        self.fc2 = _linear(dim, dim)
        self.se = SEBlock(dim, reduction, dtype)

    def forward(self, x):
        y = F.gelu(dense(layer_norm(x, self.norm), self.fc1, self.dtype))
        return x + self.se(dense(y, self.fc2, self.dtype))


class DWMlp(nn.Module):
    """MLP with a 3x3 depthwise conv (SAME) between fc1 and the activation."""

    def __init__(self, dim, hidden, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.fc1 = _linear(dim, hidden)
        self.dwconv = _conv(hidden, hidden, (3, 3), groups=hidden, padding=1)
        self.fc2 = _linear(hidden, dim)

    def forward(self, x):
        y = _conv_nhwc(dense(x, self.fc1, self.dtype), self.dwconv, self.dtype)
        return dense(F.gelu(y), self.fc2, self.dtype)


# --- blocks -------------------------------------------------------------------


class ConvNeXtBlock(nn.Module):
    """ConvNeXt block with periodic (lon-wrap) padding and a grouped conv
    (groups=12 as the reference)."""

    def __init__(self, dim, kernel_size=(4, 8), groups=12, layer_scale_init=1e-6, dtype=None):
        super().__init__()
        self.kernel_size, self.dtype = tuple(kernel_size), torch_dtype(dtype)
        self.dwconv = _conv(dim, dim, self.kernel_size, groups=groups)
        self.norm = _ln(dim)
        self.pwconv1 = _linear(dim, 4 * dim)
        self.pwconv2 = _linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale_init)))
                      if layer_scale_init > 0 else None)

    def forward(self, x):
        kh, kw = self.kernel_size
        y = _conv_nhwc(periodic_pad2d(x, (kh // 2, kw // 2)), self.dwconv, self.dtype)
        # even kernels with a symmetric pad overshoot by one: crop to the input
        y = layer_norm(y[:, : x.shape[1], : x.shape[2]], self.norm)
        y = F.gelu(dense(y, self.pwconv1, self.dtype))
        y = dense(y, self.pwconv2, self.dtype)
        if self.gamma is not None:
            y = self.gamma * y
        return x + y


class HiLoBlock(nn.Module):
    """Pre- or post-norm HiLo attention + DWMlp block."""

    def __init__(self, dim, window_size, num_heads=1, mlp_ratio=4.0, alpha=0.9,
                 pre_norm=True, dtype=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.attn = HiLoAttention(dim, num_heads, window_size, alpha, dtype)
        self.convffn = DWMlp(dim, int(dim * mlp_ratio), dtype)
        self.norm1, self.norm2 = _ln(dim), _ln(dim)

    def forward(self, x):
        if self.pre_norm:
            x = x + self.attn(layer_norm(x, self.norm1))
            return x + self.convffn(layer_norm(x, self.norm2))
        x = layer_norm(x + self.attn(x), self.norm1)
        return layer_norm(x + self.convffn(x), self.norm2)


class ConvFFNBlock(nn.Module):
    """Norm + DWMlp residual block, no attention."""

    def __init__(self, dim, mlp_ratio=4.0, dtype=None):
        super().__init__()
        self.norm2 = _ln(dim)
        self.mlp = DWMlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        return x + self.mlp(layer_norm(x, self.norm2))


class MoEWindowBlock(nn.Module):
    """Pre-norm transformer block with MoE attention and an MoE MLP.
    Returns (x, z_losses, balance_losses)."""

    def __init__(self, dim, window_size, num_heads=1, mlp_ratio=4.0, num_experts=4,
                 shift_size=(0, 0), dtype=None):
        super().__init__()
        self.norm = _ln(dim)
        self.attn = MoEWindowAttention(dim, window_size, num_heads, num_experts, shift_size,
                                       dtype)
        self.norm2 = _ln(dim)
        self.mlp = MoEMlp(dim, int(dim * mlp_ratio), num_experts, dtype=dtype)

    def forward(self, x, attr=None, rng=None):
        y, z1, b1 = self.attn(layer_norm(x, self.norm), attr, rng)
        x = x + y
        y, z2, b2 = self.mlp(layer_norm(x, self.norm2), attr, rng)
        return x + y, (z1, z2), (b1, b2)


# --- ViT / MAE blocks -----------------------------------------------------------


class ViTAttention(nn.Module):
    """Plain token MHSA over (B, N, C)."""

    def __init__(self, dim, num_heads, dtype=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, torch_dtype(dtype)
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)

    def forward(self, x):
        hd = x.shape[-1] // self.num_heads
        q, k, v = _heads(dense(x, self.qkv, self.dtype), 3, self.num_heads)
        return dense(_merge(dense_attention(q * hd ** -0.5, k, v)), self.proj, self.dtype)


class ViTCrossAttention(nn.Module):
    """Query tokens attend to a context sequence."""

    def __init__(self, dim, num_heads, dtype=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, torch_dtype(dtype)
        self.q = _linear(dim, dim)
        self.kv = _linear(dim, 2 * dim)
        self.proj = _linear(dim, dim)

    def forward(self, x, context):
        hd = x.shape[-1] // self.num_heads
        q = _heads(dense(x, self.q, self.dtype), 1, self.num_heads)[0]
        k, v = _heads(dense(context, self.kv, self.dtype), 2, self.num_heads)
        return dense(_merge(dense_attention(q * hd ** -0.5, k, v)), self.proj, self.dtype)


class ViTBlock(nn.Module):
    """Pre-norm ViT encoder block."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.attn = ViTAttention(dim, num_heads, dtype)
        self.norm1, self.norm2 = _ln(dim), _ln(dim)
        self.fc1 = _linear(dim, int(dim * mlp_ratio))
        self.fc2 = _linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.norm1))
        y = F.gelu(dense(layer_norm(x, self.norm2), self.fc1, self.dtype))
        return x + dense(y, self.fc2, self.dtype)


class ViTDecoderBlock(nn.Module):
    """Pre-norm decoder block: self-attention, cross-attention to the
    context, MLP."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, dtype=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.self_attn = ViTAttention(dim, num_heads, dtype)
        self.cross_attn = ViTCrossAttention(dim, num_heads, dtype)
        self.norm1, self.norm_q, self.norm_ctx, self.norm2 = (_ln(dim) for _ in range(4))
        self.fc1 = _linear(dim, int(dim * mlp_ratio))
        self.fc2 = _linear(int(dim * mlp_ratio), dim)

    def forward(self, x, context):
        x = x + self.self_attn(layer_norm(x, self.norm1))
        x = x + self.cross_attn(layer_norm(x, self.norm_q), layer_norm(context, self.norm_ctx))
        y = F.gelu(dense(layer_norm(x, self.norm2), self.fc1, self.dtype))
        return x + dense(y, self.fc2, self.dtype)
