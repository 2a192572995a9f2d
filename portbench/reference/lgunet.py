"""Plain float32 LGUnet: the frozen reference of both model variants.

The architecture of the reference repository's `LGUnet_all` (old-gen
relative-position-bias blocks: the VAE decoder) and `LGUnet_all_1` (new-gen
rotary blocks with a first LG stage that attends the whole coarse grid: the
0.25 deg forecast model), written with plain torch operations and no kernel.
Parameter names follow the reference's torch state_dict keys, so one set of
weights loads into this model and into the program alike.

- Layout: (B, C, H, W) in and out; channel-last inside.
- Per variable group: a patch-embedding conv, an absolute position table,
  Swin stages (shifted windows on odd blocks, PatchMerging between
  levels), a LayerNorm. The groups' features are concatenated and
  projected to the LG width; the LG stages run on the coarse grid; a linear
  split feeds per-group decoders with U-Net skips (PatchExpand between
  levels) and transposed-conv heads (VALID padding). The output holds every
  group's mean half, then every group's second half.
- Shifted-window masks keep the reference's quirk: only latitude regions
  are told apart. Masked logits take -100 in relbias blocks and -inf in
  rotary blocks. A relbias window no smaller than the grid is clamped to
  the grid, unshifted.
- The full-grid stage computes softmax(Q K^T) V in blocks of query rows
  (`ATTN_BLOCK`), each under torch.utils.checkpoint when autograd records,
  so that its memory stays one block of logits.
- `precision="fp8"` rounds both operands of every product (linear layers,
  convolutions, Q K^T, P V) to float8 e4m3 with a per-tensor scale, the
  gradient passing straight through: the benchmark's control, a step below
  the bfloat16 the configuration states. Sums stay in float32.

Everything else runs in float32; TF32 must be off (`strict_float32`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

ATTN_BLOCK = 1024  # query rows per block of the full-grid attention
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def strict_float32():
    """Switch TF32 off for cuBLAS and cuDNN: the reference's float32 is
    float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    returned in x's type; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


class Ctx:
    """The precision of a forward: "fp32", or "fp8" for the control."""

    def __init__(self, precision="fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.q = fp8 if precision == "fp8" else (lambda t: t)

    def linear(self, x, lin):
        return F.linear(self.q(x), self.q(lin.weight), lin.bias)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


# --- static tables -----------------------------------------------------------


def rope_tables(win, head_dim):
    """Axial 2-D rotary tables (sin_r, cos_r, sin_c, cos_c): the first
    quarter-ish of the half head dim turns with the row, the rest with the
    column, frequencies 10000^(-i/d)."""
    h, w = win
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    half = head_dim // 2
    d1 = half // 2
    d2 = half - d1
    a1 = rows.reshape(-1, 1) * 10000.0 ** -(np.arange(d1) / d1)
    a2 = cols.reshape(-1, 1) * 10000.0 ** -(np.arange(d2) / d2)
    return [torch.tensor(f(a), dtype=torch.float32)
            for a in (a1, a2) for f in (np.sin, np.cos)]


def rope(x, tables):
    """Rotate x (..., N, d): pairs (x[i], x[half + i]) turn by the angle of
    their frequency at the token's position."""
    s1, c1, s2, c2 = (t.to(x.device) for t in tables)
    d1, d2 = s1.shape[-1], s2.shape[-1]
    a1, a2 = x[..., :d1], x[..., d1:d1 + d2]
    b1, b2 = x[..., d1 + d2:2 * d1 + d2], x[..., 2 * d1 + d2:]
    return torch.cat([a1 * c1 - b1 * s1, a2 * c2 - b2 * s2,
                      b1 * c1 + a1 * s1, b2 * c2 + a2 * s2], dim=-1)


def relative_index(win):
    """(N, N) index of each token pair's relative offset into a
    (2h - 1)(2w - 1) bias table."""
    h, w = win
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r, c = rows.reshape(-1), cols.reshape(-1)
    dr = r[:, None] - r[None, :] + h - 1
    dc = c[:, None] - c[None, :] + w - 1
    return torch.tensor(dr * (2 * w - 1) + dc, dtype=torch.long)


def shift_mask(H, W, win, shift, neg):
    """(nW, N, N) additive mask of a shifted-window stage, or None. Regions
    split the latitude only (the reference's last longitude slice covers
    the whole row)."""
    (wh, ww), (sh, sw) = win, shift
    if (sh, sw) == (0, 0) or ww == W:
        return None
    label = np.zeros((H, W))
    label[H - wh:H - sh] = 1
    label[H - sh:] = 2
    lab = label.reshape(H // wh, wh, W // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    diff = lab[:, None, :] - lab[:, :, None]
    return torch.tensor(np.where(diff != 0, neg, 0.0), dtype=torch.float32)


# --- layers ------------------------------------------------------------------


def to_windows(x, win):
    B, H, W, C = x.shape
    wh, ww = win
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def from_windows(t, win, B, H, W):
    wh, ww = win
    t = t.reshape(B, H // wh, W // ww, wh, ww, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, win, shift, res, attn_type):
        super().__init__()
        if attn_type == "relbias" and min(res) <= min(win):
            win, shift = (min(res),) * 2, (0, 0)
        self.win, self.shift, self.heads, self.attn_type = tuple(win), tuple(shift), heads, attn_type
        self.hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if attn_type == "relbias":
            n = (2 * win[0] - 1) * (2 * win[1] - 1)
            self.relative_position_bias_table = nn.Parameter(torch.zeros(n, heads))
            self.rel = relative_index(self.win)
            neg = -100.0
        else:
            self.tables = rope_tables(self.win, self.hd)
            neg = -math.inf
        self.mask = shift_mask(*res, self.win, self.shift, neg)

    def forward(self, x, ctx):
        B, H, W, _ = x.shape
        sh, sw = self.shift
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), (1, 2))
        t = to_windows(x, self.win)
        Bw, N, _ = t.shape
        qkv = ctx.linear(t, self.qkv).reshape(Bw, N, 3, self.heads, self.hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * self.hd ** -0.5
        if self.attn_type == "rope":
            q, k = rope(q, self.tables), rope(k, self.tables)
        if self.attn_type == "rope" and self.mask is None and N >= 4096:
            out = full_attention(q, k, v, ctx)
        else:
            logits = ctx.mm(q, k.transpose(-1, -2))
            if self.attn_type == "relbias":
                bias = self.relative_position_bias_table[self.rel.to(x.device).reshape(-1)]
                logits = logits + bias.reshape(N, N, -1).permute(2, 0, 1)
            if self.mask is not None:
                nW = self.mask.shape[0]
                logits = (logits.reshape(Bw // nW, nW, self.heads, N, N)
                          + self.mask.to(x.device)[None, :, None]).reshape(Bw, self.heads, N, N)
            out = ctx.mm(torch.softmax(logits, -1), v)
        out = from_windows(out.transpose(1, 2).reshape(Bw, N, -1), self.win, B, H, W)
        if sh or sw:
            out = torch.roll(out, (sh, sw), (1, 2))
        return ctx.linear(out, self.proj)


def _attend_rows(q, k, v, ctx):
    return ctx.mm(torch.softmax(ctx.mm(q, k.transpose(-1, -2)), -1), v)


def full_attention(q, k, v, ctx):
    """softmax(q k^T) v over every token, ATTN_BLOCK query rows at a time."""
    outs = []
    for s in range(0, q.shape[2], ATTN_BLOCK):
        qb = q[:, :, s:s + ATTN_BLOCK]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_rows, qb, k, v, ctx, use_reentrant=False))
        else:
            outs.append(_attend_rows(qb, k, v, ctx))
    return torch.cat(outs, 2)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, ctx):
        return ctx.linear(F.gelu(ctx.linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    def __init__(self, cfg, dim, heads, win, shift, res):
        super().__init__()
        relbias = cfg["attn_type"] == "relbias"
        self.norm_name = "norm1" if relbias else "norm"
        eps = 1e-5 if relbias else 1e-6
        setattr(self, self.norm_name, nn.LayerNorm(dim, eps=eps))
        self.attn = WindowAttention(dim, heads, win, shift, res, cfg["attn_type"])
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * cfg["mlp_ratio"]))

    def forward(self, x, ctx):
        x = x + self.attn(getattr(self, self.norm_name)(x), ctx)
        return x + self.mlp(self.norm2(x), ctx)


class Stage(nn.Module):
    def __init__(self, cfg, dim, heads, depth, res, win, shifted=True, downsample=None,
                 upsample=None):
        super().__init__()
        half = tuple(w // 2 for w in win)
        self.blocks = nn.ModuleList(
            Block(cfg, dim, heads, win, half if shifted and j % 2 else (0, 0), res)
            for j in range(depth))
        self.downsample, self.upsample = downsample, upsample

    def forward(self, x, ctx):
        if self.downsample is not None:
            x = self.downsample(x, ctx)
        for blk in self.blocks:
            if torch.is_grad_enabled():
                x = checkpoint(blk, x, ctx, use_reentrant=False)
            else:
                x = blk(x, ctx)
        if self.upsample is not None:
            x = self.upsample(x, ctx)
        return x


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, ctx):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return ctx.linear(self.norm(x), self.reduction)


class PatchExpand(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2, eps=1e-6)

    def forward(self, x, ctx):
        x = ctx.linear(x, self.expand)
        B, H, W, C = x.shape
        x = x.reshape(B, H, W, 2, 2, C // 4).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, 2 * H, 2 * W, C // 4))


class PatchEmbed(nn.Module):
    def __init__(self, cfg, cin):
        super().__init__()
        self.proj = nn.Conv2d(cin, cfg["enc_dim"], cfg["patch_size"], cfg["stride"])

    def forward(self, x, ctx):  # (B, H, W, c) -> (B, h, w, C)
        y = F.conv2d(ctx.q(x.permute(0, 3, 1, 2)), ctx.q(self.proj.weight), self.proj.bias,
                     self.proj.stride)
        return y.permute(0, 2, 3, 1)


def _levels(cfg):
    H, W = cfg["img_size"]
    ph, pw = H // cfg["stride"][0], W // cfg["stride"][1]
    return [(ph // 2 ** i, pw // 2 ** i) for i in range(len(cfg["enc_depths"]))]


class GroupEncoder(nn.Module):
    def __init__(self, cfg, cin):
        super().__init__()
        levels = _levels(cfg)
        self.patch_embed = PatchEmbed(cfg, cin)
        self.absolute_pos_embed = nn.Parameter(torch.zeros(1, *levels[0], cfg["enc_dim"]))
        self.layers = nn.ModuleList(
            Stage(cfg, cfg["enc_dim"] * 2 ** i, cfg["enc_heads"][i], d, levels[i],
                  cfg["window_size"],
                  downsample=PatchMerging(cfg["enc_dim"] * 2 ** (i - 1)) if i else None)
            for i, d in enumerate(cfg["enc_depths"]))
        self.norm = nn.LayerNorm(cfg["enc_dim"] * 2 ** (len(levels) - 1), eps=1e-6)

    def forward(self, x, ctx):
        x = self.patch_embed(x, ctx) + self.absolute_pos_embed
        skips = []
        for stage in self.layers:
            x = stage(x, ctx)
            skips.append(x)
        return self.norm(x), skips


class GroupDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        levels = _levels(cfg)
        L = len(levels)
        self.concat_back_dim = nn.ModuleList()
        self.layers_up = nn.ModuleList()
        for i in range(L):
            lev = L - 1 - i
            dim = cfg["enc_dim"] * 2 ** lev
            self.concat_back_dim.append(nn.Linear(2 * dim, dim))
            self.layers_up.append(Stage(
                cfg, dim, cfg["enc_heads"][lev], cfg["enc_depths"][lev], levels[lev],
                cfg["window_size"], upsample=PatchExpand(dim) if lev else None))
        self.norm_up = nn.LayerNorm(cfg["enc_dim"], eps=1e-6)

    def forward(self, x, skips, ctx):
        for i, stage in enumerate(self.layers_up):
            x = ctx.linear(torch.cat([x, skips[len(skips) - 1 - i]], -1), self.concat_back_dim[i])
            x = stage(x, ctx)
        return self.norm_up(x)


class Holder(nn.Module):
    """A named container (the reference's `enc`, `dec`, `net` modules)."""


class LGUnet(nn.Module):
    """(B, C_in, H, W) -> (B, C_out, H, W), float32. `cfg` is a dict of the
    configuration's sizes (the keys of a benchmark configuration file's
    model entry)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg = dict(cfg)
        groups = len(cfg["inchans_list"])
        gdim = cfg["enc_dim"] * 2 ** (len(cfg["enc_depths"]) - 1)
        Hg, Wg = _levels(cfg)[-1]
        self.enc = Holder()
        self.enc.enc_list = nn.ModuleList(GroupEncoder(cfg, c) for c in cfg["inchans_list"])
        self.enc.proj = nn.Linear(gdim * groups, cfg["embed_dim"])
        self.net = Holder()
        self.net.pos_embed = nn.Parameter(torch.zeros(1, Hg, Wg, cfg["embed_dim"]))
        full_first = cfg.get("lg_full_attn_first", cfg["attn_type"] == "rope")
        self.net.layers = nn.ModuleList(
            Stage(cfg, cfg["embed_dim"], heads, depth, (Hg, Wg),
                  (Hg, Wg) if i == 0 and full_first else cfg["window_size"],
                  shifted=not (i == 0 and full_first))
            for i, (depth, heads) in enumerate(zip(cfg["lg_depths"], cfg["lg_heads"])))
        self.dec = Holder()
        self.dec.proj = nn.Linear(cfg["embed_dim"], gdim * groups)
        self.dec.dec_list = nn.ModuleList(GroupDecoder(cfg) for _ in cfg["outchans_list"])
        self.dec.final_proj_list = nn.ModuleList(
            nn.ConvTranspose2d(cfg["enc_dim"], c, cfg["patch_size"], cfg["stride"])
            for c in cfg["outchans_list"])

    def forward(self, x, precision="fp32"):
        ctx = Ctx(precision)
        cfg = self.cfg
        groups = torch.split(x.float().permute(0, 2, 3, 1), list(cfg["inchans_list"]), -1)
        feats, skips = [], []
        for enc, g in zip(self.enc.enc_list, groups):
            f, s = enc(g, ctx)
            feats.append(f)
            skips.append(s)
        y = ctx.linear(torch.cat(feats, -1), self.enc.proj) + self.net.pos_embed
        for stage in self.net.layers:
            y = stage(y, ctx)
        parts = torch.chunk(ctx.linear(y, self.dec.proj), len(cfg["outchans_list"]), -1)
        means, seconds = [], []
        for dec, head, part, skip, c in zip(self.dec.dec_list, self.dec.final_proj_list, parts,
                                            skips, cfg["outchans_list"]):
            h = dec(part, skip, ctx).permute(0, 3, 1, 2)
            out = F.conv_transpose2d(ctx.q(h), ctx.q(head.weight), head.bias, head.stride)
            means.append(out[:, :c // 2])
            seconds.append(out[:, c // 2:])
        return torch.cat(means + seconds, 1)
