"""Model FLOPs of the LGUnet, counted from a configuration's shapes.

Every product of the forward: the patch-embedding convolutions, each
block's qkv, projection and MLP layers, Q K^T and P V inside every window
(the full grid for a full-grid stage), PatchMerging and PatchExpand, the
fuse and split projections, the skip merges and the transposed-conv heads,
at 2 FLOPs a multiply-add. Norms, softmax and activations are not counted,
nor any recompute. A backward counts twice its forward.
"""

from __future__ import annotations


def _block(tokens, dim, window_tokens, mlp_ratio):
    linear = 2 * tokens * dim * (3 * dim + dim + 2 * int(dim * mlp_ratio))
    return linear + 4 * tokens * window_tokens * dim


def _window_tokens(res, win, attn_type):
    if attn_type == "relbias" and min(res) <= min(win):
        return min(res) ** 2  # the window clamped to the grid
    return win[0] * win[1]


def lgunet_forward_flops(cfg: dict, batch: int = 1) -> int:
    H, W = cfg["img_size"]
    ph, pw = cfg["patch_size"]
    sh, sw = cfg["stride"]
    hp, wp = (H - ph) // sh + 1, (W - pw) // sw + 1
    e, r, attn = cfg["enc_dim"], cfg["mlp_ratio"], cfg["attn_type"]
    L = len(cfg["enc_depths"])
    levels = [(H // sh // 2 ** i, W // sw // 2 ** i) for i in range(L)]
    groups = len(cfg["inchans_list"])
    total = 0
    for cin, cout in zip(cfg["inchans_list"], cfg["outchans_list"]):
        total += 2 * hp * wp * e * cin * ph * pw  # patch embed
        total += 2 * hp * wp * e * cout * ph * pw  # transposed-conv head
        for i, depth in enumerate(cfg["enc_depths"]):
            dim, res = e * 2 ** i, levels[i]
            t = res[0] * res[1]
            n = _window_tokens(res, cfg["window_size"], attn)
            if i:
                total += 2 * t * (2 * dim) * dim  # PatchMerging 4 (dim / 2) -> dim
            total += depth * _block(t, dim, n, r)  # encoder
            total += 2 * t * (2 * dim) * dim  # skip merge 2 dim -> dim
            total += depth * _block(t, dim, n, r)  # decoder
            if i:
                total += 2 * t * dim * 2 * dim  # PatchExpand dim -> 2 dim
    tg = levels[-1][0] * levels[-1][1]
    gdim = e * 2 ** (L - 1) * groups
    total += 2 * 2 * tg * gdim * cfg["embed_dim"]  # fuse and split projections
    full_first = cfg.get("lg_full_attn_first", attn == "rope")
    for i, (depth, _) in enumerate(zip(cfg["lg_depths"], cfg["lg_heads"])):
        n = tg if i == 0 and full_first else _window_tokens(levels[-1], cfg["window_size"], attn)
        total += depth * _block(tg, cfg["embed_dim"], n, r)
    return batch * total
