"""Random parameters in seconds for smoke runs and benchmarks: JAX's draw.

vaevar_tpu/utils/fast_init.py fills a model's flax parameter tree leaf by
leaf in jax's flatten order (sorted dict keys at every level), each leaf with
`(scale * rng.standard_normal(shape)).astype(float32)` from
`rng = np.random.default_rng(seed)`. `fast_init` replays that draw without
jax: it lays the port model's parameters out as the flax tree (the layout of
vaevar_tpu/utils/port_torch.py, copied here over shapes alone: Dense kernels
input-major, conv kernels (kh, kw, in, out), the uniform upper-air groups
stacked as `enc_gs`/`dec_gs`, scanned blocks stacked, shifted stacks
pairwise as `b0`/`b1`), draws its leaves in that order and maps the tree
onto the module through utils/port_jax.py, the layout's exact inverse. The
transposes, the conv layouts and the transposed conv's flip only move
values, so the same seed gives JAX's weights bit for bit.

Covered are the models a CLI builds with --fast_init: LGUnet (relbias and
rope, every stack layout, the SD variants) and VAE. Each of their parameters
is a flax leaf, and a parameter the tree does not fill raises; the buffers
(relative-position indices, rope tables) are computed from the config and
drawn in neither package. Other modules raise TypeError. Not for training:
use a trained checkpoint when the weights matter.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from vaevar_tpu_torch.utils.port_jax import lgunet_arrays_from_flax


def _t(s):  # torch Linear weight (out, in) -> flax kernel (in, out)
    return tuple(s[::-1])


def _conv(s):  # torch Conv2d (out, in, kh, kw) -> flax (kh, kw, in, out)
    return (s[2], s[3], s[1], s[0])


def _convT(s):  # torch ConvTranspose2d (in, out, kh, kw) -> flax (kh, kw, in, out)
    return (s[2], s[3], s[0], s[1])


def _grid(s, h, w):  # (1, h*w, C) or (1, h, w, C) -> flax (1, h, w, C)
    return (1, h, w, math.prod(s) // (h * w))


def _stack(trees):
    """Identical trees stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return (len(trees), *trees[0])


def _ln(sd, p):
    return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def _linear(sd, p, bias=True):
    out = {"kernel": _t(sd[f"{p}.weight"])}
    if bias and f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _block(sd, p, gen):
    attn = {"qkv": _linear(sd, f"{p}.attn.qkv"), "proj": _linear(sd, f"{p}.attn.proj")}
    if gen == "old":
        attn["rel_bias_table"] = sd[f"{p}.attn.relative_position_bias_table"]
        if f"{p}.attn.qA.weight" in sd:
            attn["qA"] = _linear(sd, f"{p}.attn.qA", bias=False)
            attn["qB"] = _linear(sd, f"{p}.attn.qB", bias=False)
    return {
        "norm1": _ln(sd, f"{p}.norm" if gen == "new" else f"{p}.norm1"),
        "norm2": _ln(sd, f"{p}.norm2"),
        "attn": attn,
        "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1"), "fc2": _linear(sd, f"{p}.mlp.fc2")},
    }


def _block_stack(sd, prefix, depth, shifted, gen):
    blocks = [_block(sd, f"{prefix}.{j}", gen) for j in range(depth)]
    if not shifted:
        return {"scan": {"b": blocks[0] if depth == 1 else _stack(blocks)}}
    if depth % 2:  # odd shifted depth: flat blk{i} modules
        return {f"blk{j}": blocks[j] for j in range(depth)}
    if depth == 2:
        return {"scan": {"b0": blocks[0], "b1": blocks[1]}}
    return {"scan": {"b0": _stack(blocks[0::2]), "b1": _stack(blocks[1::2])}}


def _group_encoder(sd, g, cfg, gen):
    p = f"enc.enc_list.{g}"
    out = {
        "patch_embed": {"kernel": _conv(sd[f"{p}.patch_embed.proj.weight"]),
                        "bias": sd[f"{p}.patch_embed.proj.bias"]},
        "pos_embed": _grid(sd[f"{p}.absolute_pos_embed"], *cfg.patches_resolution),
        "norm": _ln(sd, f"{p}.norm"),
    }
    for i, depth in enumerate(cfg.enc_depths):
        out[f"enc{i}"] = _block_stack(sd, f"{p}.layers.{i}.blocks", depth, True, gen)
        if i > 0:
            out[f"merge{i}"] = {
                "norm": _ln(sd, f"{p}.layers.{i}.downsample.norm"),
                "reduction": {"kernel": _t(sd[f"{p}.layers.{i}.downsample.reduction.weight"])},
            }
    return out


def _group_decoder(sd, g, cfg, gen):
    p = f"dec.dec_list.{g}"
    L = len(cfg.enc_depths)
    out = {"norm_up": _ln(sd, f"{p}.norm_up")}
    for i in range(L):
        out[f"concat_back{i}"] = _linear(sd, f"{p}.concat_back_dim.{i}")
        out[f"dec{i}"] = _block_stack(sd, f"{p}.layers_up.{i}.blocks",
                                      cfg.enc_depths[L - 1 - i], True, gen)
        if i < L - 1:
            out[f"expand{i}"] = {
                "expand": {"kernel": _t(sd[f"{p}.layers_up.{i}.upsample.expand.weight"])},
                "norm": _ln(sd, f"{p}.layers_up.{i}.upsample.norm"),
            }
    out["head"] = {"kernel": _convT(sd[f"dec.final_proj_list.{g}.weight"]),
                   "bias": sd[f"dec.final_proj_list.{g}.bias"]}
    return out


def lgunet_flax_shapes(model) -> dict:
    """The flax parameter tree of a port LGUnet, leaves as shapes: the tree
    `jax.eval_shape(LGUnet(cfg).init, ...)` gives, under its "params" key
    (port_torch.lgunet_params_from_torch's layout)."""
    cfg = model.cfg
    sd = {k: tuple(p.shape) for k, p in model.named_parameters()}
    gen = "old" if cfg.attn_type == "relbias" else "new"
    G = cfg.n_groups
    params = {
        "enc_proj": _linear(sd, "enc.proj"),
        "dec_proj": _linear(sd, "dec.proj"),
        "lg": {"pos_embed": _grid(sd["net.pos_embed"], *cfg.lg_resolution)},
    }
    for i, depth in enumerate(cfg.lg_depths):
        params["lg"][f"lg{i}"] = _block_stack(
            sd, f"net.layers.{i}.blocks", depth,
            not (cfg.lg_full_attn_first and i == 0), gen)
    params["enc_g0"] = _group_encoder(sd, 0, cfg, gen)
    params["dec_g0"] = _group_decoder(sd, 0, cfg, gen)
    uniform = G > 2 and len(set(cfg.inchans_list[1:])) == 1 and len(
        set(cfg.outchans_list[1:])) == 1
    if uniform:  # one nn.vmap module for groups 1..G-1
        params["enc_gs"] = _stack([_group_encoder(sd, g, cfg, gen) for g in range(1, G)])
        params["dec_gs"] = _stack([_group_decoder(sd, g, cfg, gen) for g in range(1, G)])
    else:
        for g in range(1, G):
            params[f"enc_g{g}"] = _group_encoder(sd, g, cfg, gen)
            params[f"dec_g{g}"] = _group_decoder(sd, g, cfg, gen)
    return {"params": params}


def flax_leaf_order(tree):
    """(path, shape) of every leaf in jax's flatten order: sorted keys."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], (*path, k))
        else:
            yield path, node

    return walk(tree, ())


def draw(shapes: dict, seed: int = 0, scale: float = 0.02) -> dict:
    """vaevar_tpu/utils/fast_init.py's fill of a tree of shapes: the same
    tree with float32 leaves, drawn in flax_leaf_order. Each leaf's float64
    normals are drawn into one reused buffer and scaled there, and the leaves
    are float32 views into one array: the values of JAX's
    `(scale * rng.standard_normal(shape)).astype(float32)`, without a fresh
    float64 array per leaf."""
    rng = np.random.default_rng(seed)
    leaves = list(flax_leaf_order(shapes))
    sizes = [math.prod(shape) for _, shape in leaves]
    flat = np.empty(sum(sizes), np.float32)
    buf = np.empty(max(sizes, default=0))
    out: dict = {}
    start = 0
    for (path, shape), n in zip(leaves, sizes):
        a = buf[:n]
        rng.standard_normal(out=a)
        a *= scale  # scale * a in float64, as JAX's fill computes it
        flat[start:start + n] = a  # the cast to float32
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[start:start + n].reshape(shape)
        start += n
    return out


@torch.no_grad()
def fast_init(model: torch.nn.Module, seed: int = 0, scale: float = 0.02):
    """Fill every parameter of an LGUnet or a VAE with the values JAX's
    fast_init draws for the same model, seed and scale; returns the model."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE

    if isinstance(model, LGUnet):
        arrays = lgunet_arrays_from_flax(draw(lgunet_flax_shapes(model), seed, scale),
                                         model.cfg)
    elif isinstance(model, VAE):
        halves = ("enc", "dec")
        tree = draw({"params": {h: lgunet_flax_shapes(getattr(model, h))["params"]
                                for h in halves}}, seed, scale)
        arrays = {f"{h}.{k}": v for h in halves
                  for k, v in lgunet_arrays_from_flax(tree["params"][h],
                                                      getattr(model, h).cfg).items()}
    else:
        raise TypeError(f"fast_init covers LGUnet and VAE (the flax layouts of "
                        f"vaevar_tpu/utils/fast_init.py's callers), not {type(model).__name__}")
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise ValueError(f"the flax layout misses parameters {sorted(set(params) - set(arrays))} "
                         f"and names others {sorted(set(arrays) - set(params))}")
    for name, p in params.items():
        a = arrays[name]
        if a.shape != tuple(p.shape) or p.dtype != torch.float32:
            raise ValueError(f"{name}: drawn {a.shape}, parameter {tuple(p.shape)} {p.dtype}")
        if p.device.type == "cpu":  # straight from the drawn views into the parameter
            np.copyto(p.detach().numpy(), a)
        else:
            p.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model


def param_digests(tensors: dict) -> dict:
    """{name: sha256 of the tensor's float32 bytes in C order}, for weights
    on any device: the digests tests/goldens/torch_fast_init_sha256.json
    holds of run_da's full-width models."""
    return {k: hashlib.sha256(t.detach().to("cpu", torch.float32).contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, t in sorted(tensors.items())}
