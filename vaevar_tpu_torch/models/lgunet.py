"""LGUnet: Swin-transformer U-Net backbone (PyTorch, channel-last inside).

Port of vaevar_tpu/models/lgunet.py:58-688: the old-gen relbias blocks (VAE
decoder, 1.4 deg flow model), the new-gen rope blocks with a full-grid first
LG stage (0.25 deg forecast model), and SD_attn's general path: dilated
token groups (`dilated_size`) and 3-D (T=1, H, W) LG windows with rope3
(`lg_window_size` of length 3). Macro topology: per-variable-group encoders
-> linear fuse -> LG stack at the coarse grid -> linear split -> per-group
decoders with U-Net skips -> conv heads; output (B, C_out, H, W) float32
laid out as mean || std.

The state_dict uses the reference torch key names that
vaevar_tpu/utils/port_torch.py reads (`enc.enc_list.{g}...`,
`net.layers.{i}.blocks.{j}...`, `dec.dec_list.{g}...`,
`dec.final_proj_list.{g}`), so the JAX package's weights cross over through
utils/port_jax.py. The flax `nn.vmap` over groups becomes one module per
group, `nn.scan` a ModuleList, `nn.remat` torch.utils.checkpoint
(utils/capture.py::checkpoint).

Mixed precision mirrors flax, not torch.autocast: params stay f32; layers
with a compute dtype cast input and weights to it; `x + pos_embed` promotes
the encoder and LG residual streams to f32; PatchMerging/PatchExpand and the
last LayerNorm before a head run in f32; the output is cast to f32.

A frozen parameter is cast once, not at every call (`held`): where `dense`,
the patch embed or a conv-transpose head cast a parameter that does not
require grad, and where a relbias block gathers its bias table, the call
takes a copy that its module holds, made by the same cast or gather, so
every product reads the same bits. A parameter that requires grad is cast
at every call, as flax does, so autograd routes its gradient into the f32
master: training runs the per-call casts. A held copy is remade when its
parameter's data changes (`load_state_dict`, `.to(...)`, an in-place
write), in place where it can be, so that a CUDA graph that read it reads
the new weights (da/graphs.py re-checks them with `refresh_held` before a
solve's replays); it is neither a parameter nor a buffer, and a deep copy
or a pickle of the module starts without it. The activations' casts, the
tensor-parallel row layer's own casts (parallel/tensor_parallel.py) and
models/zoo.py's casts of its own stay per call. Counters (utils/trace.py):
`lgunet.cast_held`, one per held copy a call takes (a cast or gather not
launched), and `lgunet.cast_made`, one per copy made or remade.

`LGUnet.partition(tiling)` (parallel/spatial.py, docs/SPATIAL_TRAINING.md)
puts the model in its spatially partitioned mode: the input, the output and
every activation are this rank's (lat, lon) tile of the whole (at a level
whose even tiles would cut its windows, its window-aligned tile, with a
`retile` at the level's entry and exit), the shifted windows' rolls
exchange halos with the neighbouring tiles, the pos embeds are sliced to
the tile and the shift masks keep the tile's windows; a full-grid LG stage
runs whole on every rank, on its input gathered from the tiles
(`gather_whole`), and keeps the rank's tile of its output. The parameters
stay whole and replicated.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vaevar_tpu_torch.ops import rope as rope_ops
from vaevar_tpu_torch.ops import windows as win_ops
from vaevar_tpu_torch.ops.attention import window_attention_core
from vaevar_tpu_torch.ops.posenc import relative_position_index
from vaevar_tpu_torch.utils import capture, trace
from vaevar_tpu_torch.utils.capture import checkpoint


def torch_dtype(dt):
    """A config's compute dtype as a torch dtype (accepts the numpy/JAX
    dtype objects of the reference configs)."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[np.dtype(dt).name]


class _Held(dict):
    """A module's held copies, {(parameter name, key): _HeldCopy}. Not
    state: a deep copy or a pickle of the module starts empty."""

    def __deepcopy__(self, memo):
        return _Held()

    def __reduce__(self):
        return _Held, ()


class _HeldCopy:
    """make(p), and the data it was made from: p's storage (kept, so that
    no other tensor takes its address while this copy is held) and version."""

    __slots__ = ("source", "version", "copy", "make")

    def __init__(self, p, make, old=None):
        """Made by make(p); into `old`'s copy where shape, dtype and device
        agree, so that a CUDA graph that read it reads the new one. Made
        outside any torch.func transform the call runs under (a jvp probe),
        so that the copy outlives it as a plain tensor."""
        with torch._C._DisableFuncTorch(), torch.no_grad():
            copy = make(p)
            if old is not None and (old.copy.shape, old.copy.dtype, old.copy.device) == (
                    copy.shape, copy.dtype, copy.device):
                copy = old.copy.copy_(copy)
            self.source = p.detach()
        self.version, self.copy, self.make = p._version, copy, make
        trace.count("lgunet.cast_made")

    def current(self, p) -> bool:
        s = self.source
        return (p._version == self.version and p.data_ptr() == s.data_ptr()
                and p.device == s.device and p.dtype == s.dtype and p.shape == s.shape
                and p.stride() == s.stride())


def held(module: nn.Module, name: str, key, make):
    """make(p) for the parameter p = module.<name>: made at every call where
    p requires grad; else the copy that `module` holds under `key`, made by
    make and remade only when p's data is no longer the data it was made
    from (the module docstring). Making one inside a CUDA graph capture
    raises: the graphs' warm-up makes them."""
    p = getattr(module, name)
    if p.requires_grad:
        return make(p)
    copies = module.__dict__.setdefault("_held", _Held())
    entry = copies.get((name, key))
    if entry is None or not entry.current(p):
        if capture.capturing():
            raise RuntimeError(f"{type(module).__name__}.{name}: a held copy would be made "
                               "inside a CUDA graph capture")
        copies[(name, key)] = entry = _HeldCopy(p, make, entry)
    trace.count("lgunet.cast_held")
    return entry.copy


def refresh_held(model: nn.Module) -> bool:
    """Remake, in place, each held copy of `model`'s modules whose parameter's
    data changed since it was made. False where one could not be remade in
    place (its parameter changed shape or device): that one is dropped, and
    the next call makes it anew."""
    in_place = True
    for m in model.modules():
        copies = m.__dict__.get("_held", {})
        for (name, key), entry in list(copies.items()):
            p = getattr(m, name)
            if entry.current(p):
                continue
            if (p.shape, p.device) != (entry.source.shape, entry.source.device):
                del copies[(name, key)]
                in_place = False
            else:
                copies[(name, key)] = _HeldCopy(p, entry.make, entry)
    return in_place


def cast_param(module: nn.Module, name: str, dt):
    """module.<name> (None passes) in the compute dtype `dt`: as it is where
    it has that dtype, else cast, once where it is frozen (`held`)."""
    p = getattr(module, name)
    if p is None or p.dtype == dt:
        return p
    return held(module, name, dt, lambda t: t.to(dt))


def dense(x, lin: nn.Linear, dtype=None):
    """flax nn.Dense semantics: cast input and params to `dtype` (or to
    their promoted type when None) and compute in it."""
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    return F.linear(x.to(dt), cast_param(lin, "weight", dt), cast_param(lin, "bias", dt))


def layer_norm(x, ln: nn.LayerNorm, dtype=None):
    """flax nn.LayerNorm semantics: statistics and affine in f32, result in
    `dtype` (or the promoted type of x and params when None)."""
    dt = dtype or torch.promote_types(x.dtype, ln.weight.dtype)
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(dt)


def _promote_cat(xs, dim=-1):
    dt = xs[0].dtype
    for t in xs[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in xs], dim=dim)


class WindowAttention(nn.Module):
    """Shifted-window MHSA over (B, *grid, C) with rope or relative-position
    bias (lgunet.py:58-278). 2-D undilated windows take the Swin path (dense
    or flash); dilated token groups or a 3-D window take SD_attn's general
    path (`_attend_general`, rope only), a dense attention over groups."""

    tiling = None  # parallel/spatial.py's Tiling in the partitioned mode

    def __init__(self, dim, num_heads, window_size, shift_size, resolution,
                 attn_type="rope", lora_rank=0, dtype=None, flash_min_seq=4096,
                 dilated_size=None):
        super().__init__()
        nd = len(window_size)
        dil = tuple(dilated_size) if dilated_size else (1,) * nd
        self.general = nd == 3 or any(d > 1 for d in dil)
        if self.general and attn_type != "rope":
            raise ValueError("dilated/3-D windows exist only in SD_attn (attn_type='rope'); "
                             "the old-gen relbias block has neither")
        win, shift = tuple(window_size), tuple(shift_size)
        if attn_type == "relbias" and min(resolution) <= min(win):
            # old-gen clamp: the window cannot exceed the grid (lgunet.py:95-100)
            win = (min(resolution),) * 2
            shift = (0, 0)
        self.win, self.shift, self.dil = win, shift, dil
        self.resolution = tuple(resolution)
        # this module's heads and their width: a tensor-parallel placement
        # (parallel/tensor_parallel.py) keeps a rank's slice of the heads
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attn_type = attn_type
        self.lora_rank = lora_rank
        self.dtype = dtype
        self.flash_min_seq = flash_min_seq
        head_dim = self.head_dim
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if lora_rank > 0:
            self.qA = nn.Linear(dim, lora_rank, bias=False)
            self.qB = nn.Linear(lora_rank, dim, bias=False)
        if attn_type == "rope":
            tables = (rope_ops.rope3_tables(win, head_dim) if nd == 3
                      else rope_ops.rope2_tables(win, head_dim))
            self.table_names = [f"rope{i}" for i in range(len(tables))]
            for name, t in zip(self.table_names, tables):
                self.register_buffer(name, torch.from_numpy(t), persistent=False)
            neg = -np.inf
        elif attn_type == "relbias":
            T = (2 * win[0] - 1) * (2 * win[1] - 1)
            self.relative_position_bias_table = nn.Parameter(torch.zeros(T, num_heads))
            self.register_buffer(
                "rel_index", torch.from_numpy(relative_position_index(win).reshape(-1)),
                persistent=False)
            neg = -100.0  # old-gen fill (swinblock.py:258)
        else:
            raise ValueError(f"attn_type {attn_type!r}")
        if self.general:
            mask = win_ops.sd_attention_mask(tuple(resolution), win, shift, dil, neg=neg)
        else:
            mask = win_ops.swin_attention_mask(*resolution, win, shift, neg=neg)
        self.register_buffer(
            "mask", None if mask is None else torch.from_numpy(mask), persistent=False)

    def _qkv(self, xw):
        """(B_, N, C) tokens -> q, k, v (B_, h, N, hd), LoRA q added."""
        qkv = dense(xw, self.qkv, self.dtype)
        width = self.num_heads * self.head_dim
        if self.lora_rank > 0:
            q_lora = dense(dense(xw, self.qA, self.dtype), self.qB, self.dtype)
            qkv = torch.cat([qkv[..., :width] + q_lora, qkv[..., width:]], dim=-1)
        B_, N = xw.shape[:2]
        qkv = qkv.reshape(B_, N, 3, self.num_heads, self.head_dim)
        return qkv.permute(2, 0, 3, 1, 4)

    def _rope(self, t):
        tables = tuple(getattr(self, n) for n in self.table_names)
        apply = rope_ops.apply_rope3 if len(tables) == 6 else rope_ops.apply_rope2
        return apply(t, tables)

    def forward(self, x):
        return dense(self.attend(x), self.proj, self.dtype)

    def attend(self, x):
        """The heads' outputs (B, *grid, h * hd) of x, before `proj`."""
        if self.general:
            return self._attend_general(x)
        H, W = x.shape[1:3]
        wh, ww = self.win
        sh, sw = self.shift
        N = wh * ww
        h = self.num_heads
        roll = win_ops.shift2d if self.tiling is None else self.tiling.roll
        if sh or sw:
            x = roll(x, -sh, -sw)
        xw = win_ops.window_partition(x, self.win)
        B_ = xw.shape[0]
        q, k, v = self._qkv(xw)  # (B_, h, N, hd)

        if self.attn_type == "rope":
            q = self._rope(q) * self.scale
            k = self._rope(k)
            out = window_attention_core(q, k, v, self.mask, self.flash_min_seq)
        else:
            q = q * self.scale
            logits = q.float() @ k.float().transpose(-1, -2)
            index = self.rel_index
            logits = logits + held(
                self, "relative_position_bias_table", "gathered",
                lambda t: t.float()[index].reshape(N, N, h).permute(2, 0, 1)[None])
            if self.mask is not None:
                nW = self.mask.shape[0]
                logits = (logits.reshape(B_ // nW, nW, h, N, N)
                          + self.mask[None, :, None]).reshape(B_, h, N, N)
            w = torch.softmax(logits, dim=-1).to(v.dtype)
            out = w @ v

        out = out.transpose(1, 2).reshape(B_, N, h * self.head_dim)
        x = win_ops.window_reverse(out, self.win, H, W)
        if sh or sw:
            x = roll(x, sh, sw)
        return x

    def tile_mask(self, tiling, layout):
        """This attention's shift mask in the partitioned mode on `tiling`,
        its grid tiled by `layout` (parallel/spatial.py, tiles of whole
        windows): the rows of this rank's windows, in raster order (None
        without a mask)."""
        H, W = self.resolution
        rows, cols = layout.tile(tiling.s, tiling.w)
        (wh, ww), N = self.win, self.win[0] * self.win[1]
        if self.mask is None:
            return None
        m = self.mask.reshape(H // wh, W // ww, N, N)
        m = m[rows.start // wh:rows.stop // wh, cols.start // ww:cols.stop // ww]
        return m.reshape(-1, N, N).contiguous()

    def _attend_general(self, x):
        """SD_attn's general path (lgunet.py:160-225) on x (B, *grid, C),
        grid of len(window) axes. Each grid axis splits into (n, w, d): a
        group is one (n..., d...) pair, in window-raster then
        dilated-offset-raster order, its tokens the (w...) raster. The roll
        engages only when the longitude shift is nonzero. Logits in f32,
        softmax weights cast to v's dtype."""
        win, dil, shift = self.win, self.dil, self.shift
        nd = len(win)
        B, grid, C = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
        h = self.num_heads
        N = math.prod(win)
        axes = tuple(range(1, 1 + nd))
        engage = shift[-1] > 0
        if engage:
            x = torch.roll(x, tuple(-s for s in shift), axes)
        rs = [B]
        for g, w, d in zip(grid, win, dil):
            rs += [g // (w * d), w, d]
        perm = ([0] + [1 + 3 * i for i in range(nd)] + [3 + 3 * i for i in range(nd)]
                + [2 + 3 * i for i in range(nd)] + [1 + 3 * nd])
        xw = x.reshape(*rs, C).permute(perm).reshape(-1, N, C)
        B_ = xw.shape[0]
        q, k, v = self._qkv(xw)
        q = self._rope(q) * self.scale
        k = self._rope(k)
        logits = q.float() @ k.float().transpose(-1, -2)
        if self.mask is not None:
            nW = self.mask.shape[0]
            logits = (logits.reshape(B_ // nW, nW, h, N, N)
                      + self.mask[None, :, None]).reshape(B_, h, N, N)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (w @ v).transpose(1, 2)  # (B_, N, h, hd)
        out = out.reshape(B, *(g // (w_ * d_) for g, w_, d_ in zip(grid, win, dil)),
                          *dil, *win, h * self.head_dim)
        x = out.permute([perm.index(i) for i in range(len(perm))]).reshape(B, *grid, -1)
        if engage:
            x = torch.roll(x, shift, axes)
        return x


class Mlp(nn.Module):
    def __init__(self, dim, hidden, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dtype = dtype

    def forward(self, x):
        return dense(self.hidden(x), self.fc2, self.dtype)

    def hidden(self, x):
        """The hidden units (fc1's outputs, all of them or a tensor-parallel
        rank's block) after the exact erf GELU."""
        return F.gelu(dense(x, self.fc1, self.dtype))


class Block(nn.Module):
    """Pre-norm window-attention block (lgunet.py:293-342). Old-gen blocks
    name their first norm `norm1` with eps 1e-5, new-gen `norm` with 1e-6."""

    def __init__(self, cfg, dim, num_heads, window, shift, resolution, dilated_size=None):
        super().__init__()
        self.dtype = cfg.dtype
        eps = 1e-5 if cfg.attn_type == "relbias" else 1e-6
        self.norm_name = "norm1" if cfg.attn_type == "relbias" else "norm"
        setattr(self, self.norm_name, nn.LayerNorm(dim, eps=eps))
        self.attn = WindowAttention(
            dim, num_heads, window, shift, resolution, cfg.attn_type,
            cfg.lora_rank, cfg.dtype, cfg.flash_min_seq, dilated_size)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), cfg.dtype)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, getattr(self, self.norm_name), self.dtype))
        return x + self.mlp(layer_norm(x, self.norm2, self.dtype))


class BasicLayer(nn.Module):
    """One stage: `depth` blocks, with odd blocks shifted by half a window
    per axis when `shifted` (the flax scan over unshifted/shifted pairs,
    lgunet.py:373-432), plus an optional `downsample` applied first or
    `upsample` applied last (the reference's stage key layout). With
    `dilated`, `cfg.dilated_size` is trimmed to the window's rank
    (lgunet.py:394-397); the full-grid LG stage passes dilated=False. In the
    partitioned mode `moves` holds the (from, to) layouts of the retile
    before the blocks (after `downsample`) and of the one after them
    (before `upsample`), each None where the tiles stay."""

    tiling = None  # parallel/spatial.py's Tiling in the partitioned mode
    moves = (None, None)

    def __init__(self, cfg, dim, num_heads, depth, resolution, window,
                 shifted=True, dilated=True, downsample=None, upsample=None):
        super().__init__()
        dil = None
        if dilated and any(d > 1 for d in cfg.dilated_size):
            dil = tuple(cfg.dilated_size[-len(window):])
            if len(dil) != len(window):
                # the JAX package fails here too (a TypeError in the reshape
                # of _call_general): refuse at construction
                raise ValueError(
                    f"dilated_size {tuple(cfg.dilated_size)} has fewer entries than the "
                    f"{len(window)}-D window {tuple(window)} it applies to (window_size "
                    f"{tuple(cfg.window_size)}, lg_window_size {cfg.lg_window_size}); "
                    "give dilated_size one entry per window axis")
        zero, half = (0,) * len(window), tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList(
            Block(cfg, dim, num_heads, window, half if shifted and j % 2 else zero,
                  resolution, dil)
            for j in range(depth))
        self.downsample = downsample
        self.upsample = upsample
        self.remat = cfg.remat

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        if self.moves[0] is not None:
            x = self.tiling.retile(x, *self.moves[0])
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x)
            else:
                x = blk(x)
        if self.moves[1] is not None:
            x = self.tiling.retile(x, *self.moves[1])
        if self.upsample is not None:
            x = self.upsample(x)
        return x


class PatchMerging(nn.Module):
    """2x2 space-to-depth + norm + linear 4C -> 2C, in f32 (lgunet.py:435-453)."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return dense(layer_norm(x, self.norm), self.reduction)


class PatchExpand(nn.Module):
    """Linear C -> 2C + depth-to-space 2x2 + norm, in f32 (lgunet.py:456-467)."""

    def __init__(self, dim):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2, eps=1e-6)

    def forward(self, x):
        x = dense(x, self.expand)
        B, H, W, C = x.shape
        x = x.reshape(B, H, W, 2, 2, C // 4).permute(0, 1, 3, 2, 4, 5)
        return layer_norm(x.reshape(B, 2 * H, 2 * W, C // 4), self.norm)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg, in_chans):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, cfg.enc_dim, cfg.patch_size, cfg.stride)
        self.dtype = cfg.dtype

    def forward(self, x):  # (B, H, W, c) -> (B, h, w, C), VALID padding
        dt = self.dtype or torch.promote_types(x.dtype, self.proj.weight.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), cast_param(self.proj, "weight", dt),
                     cast_param(self.proj, "bias", dt), self.proj.stride)
        return y.permute(0, 2, 3, 1)


def _tile_of(pe, tiling, layout=None):
    """The (1, H, W, C) pos embed `pe`, or its tile in the partitioned mode
    (under `layout`, else the even tiles): the whole parameter takes a
    gradient that is zero outside the tile."""
    if tiling is None:
        return pe
    if layout is None:
        rows, cols = tiling.tile(pe.shape[1:3])
    else:
        rows, cols = layout.tile(tiling.s, tiling.w)
    return pe[:, rows, cols]


class GroupEncoder(nn.Module):
    """Per-variable-group hierarchical encoder (lgunet.py:470-504)."""

    tiling = None  # parallel/spatial.py's Tiling in the partitioned mode

    def __init__(self, cfg, in_chans):
        super().__init__()
        pr = cfg.patches_resolution
        self.patch_embed = _PatchEmbed(cfg, in_chans)
        self.absolute_pos_embed = nn.Parameter(torch.zeros(1, pr[0], pr[1], cfg.enc_dim))
        self.layers = nn.ModuleList()
        for i, depth in enumerate(cfg.enc_depths):
            dim = cfg.enc_dim * 2 ** i
            res = (pr[0] // 2 ** i, pr[1] // 2 ** i)
            self.layers.append(BasicLayer(
                cfg, dim, cfg.enc_heads[i], depth, res, cfg.window_size,
                downsample=PatchMerging(dim // 2) if i > 0 else None))
        self.norm = nn.LayerNorm(cfg.enc_dim * 2 ** (len(cfg.enc_depths) - 1), eps=1e-6)

    def forward(self, x):
        x = self.patch_embed(x) + _tile_of(self.absolute_pos_embed, self.tiling)  # f32 stream
        skips = []
        for stage in self.layers:
            x = stage(x)
            skips.append(x)
        return layer_norm(x, self.norm), skips


class GroupDecoder(nn.Module):
    """Per-variable-group decoder with U-Net skips (lgunet.py:507-538); the
    conv head lives in `Decoder.final_proj_list`."""

    def __init__(self, cfg):
        super().__init__()
        pr = cfg.patches_resolution
        L = len(cfg.enc_depths)
        self.dtype = cfg.dtype
        self.concat_back_dim = nn.ModuleList()
        self.layers_up = nn.ModuleList()
        for i in range(L):
            dim = cfg.enc_dim * 2 ** (L - 1 - i)
            res = (pr[0] // 2 ** (L - 1 - i), pr[1] // 2 ** (L - 1 - i))
            self.concat_back_dim.append(nn.Linear(2 * dim, dim))
            self.layers_up.append(BasicLayer(
                cfg, dim, cfg.enc_heads[L - 1 - i], cfg.enc_depths[L - 1 - i],
                res, cfg.window_size,
                upsample=PatchExpand(dim) if i < L - 1 else None))
        self.norm_up = nn.LayerNorm(cfg.enc_dim, eps=1e-6)

    def forward(self, x, skips):
        L = len(self.layers_up)
        for i, stage in enumerate(self.layers_up):
            x = _promote_cat([x, skips[L - 1 - i]])
            x = dense(x, self.concat_back_dim[i], self.dtype)
            x = stage(x)
        return layer_norm(x, self.norm_up)


def conv_transpose_valid(x, ct: nn.ConvTranspose2d, dtype=None):
    """flax ConvTranspose(padding="VALID") on (B, H, W, C): output
    in*stride + max(k - stride, 0) per axis, which torch's transposed
    convolution gives for k >= stride (721 rows from 360 at k=3, s=2)."""
    dt = dtype or torch.promote_types(x.dtype, ct.weight.dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), cast_param(ct, "weight", dt),
                           cast_param(ct, "bias", dt), ct.stride)
    return y.permute(0, 2, 3, 1)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.enc_list = nn.ModuleList(GroupEncoder(cfg, c) for c in cfg.inchans_list)
        fused = cfg.enc_dim * 2 ** (len(cfg.enc_depths) - 1) * cfg.n_groups
        self.proj = nn.Linear(fused, cfg.embed_dim)


class LGStack(nn.Module):
    """Coarse-grid transformer (lgunet.py:541-580): stage 0 attends the full
    grid unshifted when `lg_full_attn_first`, later stages are windowed. A
    3-D `lg_window_size` runs the windowed stages on x[:, None], a
    (B, 1, Hg, Wg, C) grid, with 3-D windows and rope3 (shift w // 2 per
    axis); the full-grid stage stays 2-D and undilated. In the partitioned
    mode the stack runs on the tiles of `layout` (retiled from and back to
    the encoder's last level by `moves`), and the full-grid stage runs whole
    on every rank."""

    tiling = None  # parallel/spatial.py's Tiling in the partitioned mode
    layout = None
    moves = (None, None)

    def __init__(self, cfg):
        super().__init__()
        Hg, Wg = cfg.lg_resolution
        self.win3d = len(cfg.lg_window) == 3
        self.full_first = cfg.lg_full_attn_first
        self.pos_embed = nn.Parameter(torch.zeros(1, Hg, Wg, cfg.embed_dim))
        self.layers = nn.ModuleList()
        for i, (depth, heads) in enumerate(zip(cfg.lg_depths, cfg.lg_heads)):
            if i == 0 and self.full_first:
                stage = BasicLayer(cfg, cfg.embed_dim, heads, depth, (Hg, Wg), (Hg, Wg),
                                   shifted=False, dilated=False)
            else:
                stage = BasicLayer(cfg, cfg.embed_dim, heads, depth,
                                   (1, Hg, Wg) if self.win3d else (Hg, Wg),
                                   tuple(cfg.lg_window))
            self.layers.append(stage)

    def forward(self, x):
        if self.moves[0] is not None:
            x = self.tiling.retile(x, *self.moves[0])
        x = x + _tile_of(self.pos_embed, self.tiling, self.layout)
        if self.win3d:
            x = x[:, None]
        for i, stage in enumerate(self.layers):
            if i == 0 and self.full_first and self.win3d:
                x = stage(x[:, 0])[:, None]
            elif i == 0 and self.full_first and self.tiling is not None:
                # every token attends to every other: the stage runs whole on
                # every rank, which keeps its tile of the output
                rows, cols = self.layout.tile(self.tiling.s, self.tiling.w)
                x = stage(self.tiling.gather_whole(x, self.layout))[:, rows, cols]
            else:
                x = stage(x)
        x = x[:, 0] if self.win3d else x
        if self.moves[1] is not None:
            x = self.tiling.retile(x, *self.moves[1])
        return x


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        gdim = cfg.enc_dim * 2 ** (len(cfg.enc_depths) - 1)
        self.proj = nn.Linear(cfg.embed_dim, gdim * cfg.n_groups)
        self.dec_list = nn.ModuleList(GroupDecoder(cfg) for _ in cfg.outchans_list)
        self.final_proj_list = nn.ModuleList(
            nn.ConvTranspose2d(cfg.enc_dim, c, cfg.patch_size, cfg.stride)
            for c in cfg.outchans_list)


class LGUnet(nn.Module):
    """(B, C_in, H, W) -> (B, C_out, H, W) float32, mean || std layout."""

    _tiling = None  # set by `partition`

    def __init__(self, cfg):
        super().__init__()
        cfg = cfg.replace(dtype=torch_dtype(cfg.dtype))
        self.cfg = cfg
        self.enc = Encoder(cfg)
        self.net = LGStack(cfg)
        self.dec = Decoder(cfg)

    def forward(self, x):
        cfg = self.cfg
        x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        if cfg.dtype is not None:
            x = x.to(cfg.dtype)
        groups = torch.split(x, list(cfg.inchans_list), dim=-1)
        feats, skips = [], []
        for enc, g in zip(self.enc.enc_list, groups):
            f, ds = enc(g)
            feats.append(f)
            skips.append(ds)
        fused = dense(_promote_cat(feats), self.enc.proj, cfg.dtype)
        out = self.net(fused)
        out = dense(out, self.dec.proj, cfg.dtype)
        parts = torch.chunk(out, cfg.n_groups, dim=-1)
        means, stds = [], []
        for gi, (dec, head) in enumerate(zip(self.dec.dec_list, self.dec.final_proj_list)):
            y = conv_transpose_valid(dec(parts[gi], skips[gi]), head, cfg.dtype)
            c = cfg.outchans_list[gi]
            means.append(y[..., : c // 2])
            stds.append(y[..., c // 2:])
        y = torch.cat(means + stds, dim=-1)
        return y.permute(0, 3, 1, 2).float()

    def partition(self, tiling):
        """Put the model in its spatially partitioned mode on `tiling`
        (parallel/spatial.py::Tiling, a rank's tile of an sh x sw mesh) and
        return it: forward then maps this rank's (B, C_in, h, w) tile of the
        input to its tile of the output, exchanging halos with the other
        ranks of the tiling (every rank of it runs the same forward). Each
        level runs on the tiles of `Tiling.layout` for its windows: the even
        tiles, or window-aligned ones where those would cut a window; the
        full-grid LG stage runs whole on every rank. The parameters stay
        whole. Raises ValueError, naming what it refuses, where a level has
        fewer window rows or columns than ranks along an axis, a patch
        embed or head's kernel exceeds its stride on a split axis or a tile
        its stride does not divide, PatchMerging or PatchExpand would see a
        tile of odd size, the model takes the general path (dilated or 3-D
        windows), or its blocks are tensor-parallel. Every check runs
        before any change, so a refused model stays as it was. A second
        call with the same tiling does nothing."""
        from vaevar_tpu_torch.parallel.tensor_parallel import _RowParallel

        if self._tiling is not None:
            if self._tiling != tiling:
                raise ValueError("the model is partitioned on another tiling already")
            return self
        cfg = self.cfg
        mesh = f"mesh sh={tiling.sh}, sw={tiling.sw}"
        for name, m in self.named_modules():
            if isinstance(m, WindowAttention) and m.general:
                raise ValueError(
                    f"{name}: the general path (dilated {m.dil} or 3-D window {m.win} on the "
                    f"{'x'.join(map(str, m.resolution))} grid) groups tokens across the whole "
                    f"grid ({mesh}); it is not partitioned")
            if isinstance(m, _RowParallel):
                raise ValueError(f"{name}: a tensor-parallel block ({mesh}); the trainers' "
                                 "mesh has no tp axis")
        H, W = cfg.img_size
        for axis, n, size, k, st in (("lat", tiling.sh, H, cfg.patch_size[0], cfg.stride[0]),
                                     ("lon", tiling.sw, W, cfg.patch_size[1], cfg.stride[1])):
            if n > 1 and (k != st or (size // n) % st):
                raise ValueError(
                    f"the patch embed and head (kernel {k}, stride {st} along {axis}) on a "
                    f"{axis} tile of {size // n} of the {H}x{W} grid ({mesh}): a kernel that "
                    "exceeds its stride, or a tile its stride does not divide, reads across "
                    "tiles")
        tiling.tile((H, W), "the input grid")
        moves, layouts = self._layouts(tiling, mesh)
        # every check before any change: a refused model stays as it was
        masks = []
        for name, m in self.named_modules():
            if isinstance(m, BasicLayer) and not (self.net.full_first and m is self.net.layers[0]):
                for blk in m.blocks:
                    masks.append((blk.attn, blk.attn.tile_mask(tiling, layouts[name])))
        for m, mask in masks:
            m.mask, m.tiling = mask, tiling
        for name, m in self.named_modules():
            if isinstance(m, (GroupEncoder, LGStack, BasicLayer)):
                m.tiling = tiling
            if name in moves:
                m.moves = moves[name]
        self.net.layout = layouts["net"]
        self._tiling = tiling
        return self

    def _layouts(self, tiling, mesh):
        """The partitioned mode's plan on `tiling`: ({module name: (move in,
        move out)}, {module name: the layout its blocks run on}), each move
        a (from, to) pair of layouts or None. The encoder's levels start on
        the patch embed's even tiles and each runs on `Tiling.layout` for
        its windows (PatchMerging halves the previous level's tiles, which
        must be even); the LG stack runs on the layout of its windowed
        stages (the encoder's last, without any); each decoder level leaves
        its blocks on half its next level's tiles (PatchExpand doubles
        them), the last on the patch embed's even tiles for the head."""
        cfg = self.cfg
        moves, layouts = {}, {}

        def level_layout(stage, res, what):
            wins = {tuple(blk.attn.win) for blk in stage.blocks}
            return tiling.layout(res, wins.pop() if wins else None, what)

        pr = cfg.patches_resolution
        L = len(cfg.enc_depths)
        res = [(pr[0] // 2 ** i, pr[1] // 2 ** i) for i in range(L)]
        first = tiling.layout(pr, None, "the patch embed's grid")
        for g in range(len(self.enc.enc_list)):
            cur = first
            for i in range(L):
                name = f"enc.enc_list.{g}.layers.{i}"
                stage = self.enc.enc_list[g].layers[i]
                if i > 0:
                    if not cur.even():
                        raise ValueError(f"{name}: PatchMerging of level {i - 1}'s tiles "
                                         f"({cur}) of the {res[i - 1][0]}x{res[i - 1][1]} grid "
                                         f"({mesh}) needs even tiles")
                    cur = cur.halved()
                want = level_layout(stage, res[i], f"{name}, level {i}")
                moves[name] = (None if cur == want else (cur, want), None)
                layouts[name] = cur = want
        deepest = cur
        lg = deepest
        for i, stage in enumerate(self.net.layers):
            name = f"net.layers.{i}"
            if i == 0 and self.net.full_first:
                continue  # gathered whole: any tiles
            lg = level_layout(stage, cfg.lg_resolution, f"{name}, the LG grid")
        for i in range(len(self.net.layers)):
            layouts[f"net.layers.{i}"] = lg
        layouts["net"] = lg
        moves["net"] = (None if lg == deepest else (deepest, lg),
                        None if lg == deepest else (lg, deepest))
        for g in range(len(self.dec.dec_list)):
            for i in range(L):
                name = f"dec.dec_list.{g}.layers_up.{i}"
                stage = self.dec.dec_list[g].layers_up[i]
                level = L - 1 - i
                here = level_layout(stage, res[level], f"{name}, level {level}")
                if level > 0:
                    nxt = layouts[f"enc.enc_list.{g}.layers.{level - 1}"]
                    if not nxt.even():
                        raise ValueError(f"{name}: PatchExpand onto level {level - 1}'s tiles "
                                         f"({nxt}) of the {res[level - 1][0]}x"
                                         f"{res[level - 1][1]} grid ({mesh}) needs even tiles")
                    out = nxt.halved()
                else:
                    out = first
                moves[name] = (None, None if here == out else (here, out))
                layouts[name] = here
        return moves, layouts
