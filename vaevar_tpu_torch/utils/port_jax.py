"""Carry the JAX package's LGUnet parameters over to the port.

`lgunet_state_dict_from_flax` is the exact inverse of
vaevar_tpu/utils/port_torch.py::lgunet_params_from_torch: it takes the flax
parameter tree (numpy arrays, with or without the top "params" key) and
returns the port's state_dict under the reference torch key names. It
transposes Dense kernels, inverts the conv layout and the spatial flip of
the transposed-conv kernel, and unstacks the group (`enc_gs`/`dec_gs`) and
scan axes; shifted stacks are pairwise (`b0` holds blocks 0, 2, ...,
`b1` blocks 1, 3, ...). `vae_state_dict_from_flax` does the same for a
VAE tree, the inverse of port_torch.vae_params_from_torch.
`zoo_state_dict_from_flax` maps a zoo module's tree (models/zoo.py keeps
the flax names) by structure alone.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(kernel):  # flax Dense kernel (in, out) -> torch Linear weight (out, in)
    return np.asarray(kernel).T


def _conv(kernel):  # flax Conv (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _convT(kernel):
    """flax ConvTranspose (kh, kw, in, out) -> torch ConvTranspose2d
    (in, out, kh, kw), undoing the spatial flip of port_torch._convT."""
    return np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)


def _index(tree, i):
    """Slice every leaf of a nested dict at position i of its leading axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _linear(sd, p, tree):
    sd[f"{p}.weight"] = _t(tree["kernel"])
    if "bias" in tree:
        sd[f"{p}.bias"] = tree["bias"]


def _ln(sd, p, tree):
    sd[f"{p}.weight"] = tree["scale"]
    sd[f"{p}.bias"] = tree["bias"]


def _block(sd, p, tree, gen):
    _ln(sd, f"{p}.norm1" if gen == "old" else f"{p}.norm", tree["norm1"])
    _ln(sd, f"{p}.norm2", tree["norm2"])
    attn = tree["attn"]
    _linear(sd, f"{p}.attn.qkv", attn["qkv"])
    _linear(sd, f"{p}.attn.proj", attn["proj"])
    if gen == "old":
        sd[f"{p}.attn.relative_position_bias_table"] = attn["rel_bias_table"]
    for name in ("qA", "qB"):
        if name in attn:
            _linear(sd, f"{p}.attn.{name}", attn[name])
    _linear(sd, f"{p}.mlp.fc1", tree["mlp"]["fc1"])
    _linear(sd, f"{p}.mlp.fc2", tree["mlp"]["fc2"])


def _block_stack(sd, prefix, tree, depth, shifted, gen):
    """flax BlockStack tree -> `{prefix}.{j}` blocks (port_torch._block_stack)."""
    if not shifted:
        body = tree["scan"]["b"]
        blocks = [body] if depth == 1 else [_index(body, j) for j in range(depth)]
    elif depth % 2:
        blocks = [tree[f"blk{j}"] for j in range(depth)]
    elif depth == 2:
        blocks = [tree["scan"]["b0"], tree["scan"]["b1"]]
    else:
        b0, b1 = tree["scan"]["b0"], tree["scan"]["b1"]
        blocks = [_index(b1 if j % 2 else b0, j // 2) for j in range(depth)]
    for j, b in enumerate(blocks):
        _block(sd, f"{prefix}.{j}", b, gen)


def _group_encoder(sd, g, tree, cfg, gen):
    p = f"enc.enc_list.{g}"
    sd[f"{p}.patch_embed.proj.weight"] = _conv(tree["patch_embed"]["kernel"])
    sd[f"{p}.patch_embed.proj.bias"] = tree["patch_embed"]["bias"]
    sd[f"{p}.absolute_pos_embed"] = tree["pos_embed"]
    _ln(sd, f"{p}.norm", tree["norm"])
    for i, depth in enumerate(cfg.enc_depths):
        _block_stack(sd, f"{p}.layers.{i}.blocks", tree[f"enc{i}"], depth, True, gen)
        if i > 0:
            m = tree[f"merge{i}"]
            _ln(sd, f"{p}.layers.{i}.downsample.norm", m["norm"])
            sd[f"{p}.layers.{i}.downsample.reduction.weight"] = _t(m["reduction"]["kernel"])


def _group_decoder(sd, g, tree, cfg, gen):
    p = f"dec.dec_list.{g}"
    L = len(cfg.enc_depths)
    _ln(sd, f"{p}.norm_up", tree["norm_up"])
    for i in range(L):
        _linear(sd, f"{p}.concat_back_dim.{i}", tree[f"concat_back{i}"])
        _block_stack(sd, f"{p}.layers_up.{i}.blocks", tree[f"dec{i}"],
                     cfg.enc_depths[L - 1 - i], True, gen)
        if i < L - 1:
            e = tree[f"expand{i}"]
            sd[f"{p}.layers_up.{i}.upsample.expand.weight"] = _t(e["expand"]["kernel"])
            _ln(sd, f"{p}.layers_up.{i}.upsample.norm", e["norm"])
    sd[f"dec.final_proj_list.{g}.weight"] = _convT(tree["head"]["kernel"])
    sd[f"dec.final_proj_list.{g}.bias"] = tree["head"]["bias"]


def lgunet_state_dict_from_flax(flax_params, cfg) -> dict[str, torch.Tensor]:
    """flax LGUnet params -> port state_dict (float32 CPU tensors)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in lgunet_arrays_from_flax(flax_params, cfg).items()}


def lgunet_arrays_from_flax(flax_params, cfg) -> dict:
    """lgunet_state_dict_from_flax's mapping without its copy: {port key:
    numpy view of the flax leaf (transposed, flipped or indexed)}."""
    params = flax_params.get("params", flax_params)
    gen = "old" if cfg.attn_type == "relbias" else "new"
    sd: dict = {}
    _linear(sd, "enc.proj", params["enc_proj"])
    _linear(sd, "dec.proj", params["dec_proj"])
    sd["net.pos_embed"] = params["lg"]["pos_embed"]
    for i, depth in enumerate(cfg.lg_depths):
        full = i == 0 and cfg.lg_full_attn_first
        _block_stack(sd, f"net.layers.{i}.blocks", params["lg"][f"lg{i}"],
                     depth, not full, gen)
    for g in range(cfg.n_groups):
        if f"enc_g{g}" in params:
            enc, dec = params[f"enc_g{g}"], params[f"dec_g{g}"]
        else:  # uniform upper-air groups 1.. are one vmapped module
            enc, dec = _index(params["enc_gs"], g - 1), _index(params["dec_gs"], g - 1)
        _group_encoder(sd, g, enc, cfg, gen)
        _group_decoder(sd, g, dec, cfg, gen)
    return sd


def vae_state_dict_from_flax(flax_params, enc_cfg, dec_cfg) -> dict[str, torch.Tensor]:
    """flax VAE params ({"enc": ..., "dec": ...}, with or without the top
    "params" key) -> the port VAE's state_dict under the reference `enc.` /
    `dec.` prefixes: the exact inverse of port_torch.vae_params_from_torch."""
    params = flax_params.get("params", flax_params)
    sd = {}
    for half, cfg in (("enc", enc_cfg), ("dec", dec_cfg)):
        for k, v in lgunet_state_dict_from_flax(params[half], cfg).items():
            sd[f"{half}.{k}"] = v
    return sd


def forecast_trainable_from_flax(trainable, cfg) -> dict:
    """The JAX forecast trainer's trainable ({"model": flax LGUnet params,
    and "max_logvar"/"min_logvar" (1, n) with Possloss}, as numpy) -> the
    port's: {"model": state_dict, and the bounds as float32 tensors}. Load
    the state_dict into the port's LGUnet and hand the bounds to the
    trainable that forecast_trainer's init_fn builds."""
    out = {"model": lgunet_state_dict_from_flax(trainable["model"], cfg)}
    for k in ("max_logvar", "min_logvar"):
        if k in trainable:
            out[k] = torch.from_numpy(np.array(trainable[k], dtype=np.float32))
    return out


def zoo_state_dict_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """flax params of a models/zoo.py module (with or without the top
    "params" key) -> the port module's state_dict, by structure: a Dense
    kernel (in, out) becomes a Linear weight (out, in), a Conv kernel
    (kh, kw, in/groups, out) a Conv2d weight (out, in/groups, kh, kw), a
    LayerNorm's `scale` its `weight`; every other leaf (biases, the stacked
    expert banks w1/b1/w2/b2 in their (E, in, out) layout, the relative
    position `table`, ScaleOffset's and ConvNeXt's `gamma`/`beta`) carries
    over as it is."""
    sd: dict = {}

    def walk(prefix, tree):
        leaves = {k for k, v in tree.items() if not isinstance(v, dict)}
        if "kernel" in leaves:
            k = np.asarray(tree["kernel"])
            sd[f"{prefix}weight"] = _t(k) if k.ndim == 2 else _conv(k)
            leaves.discard("kernel")
        elif "scale" in leaves:
            sd[f"{prefix}weight"] = tree["scale"]
            leaves.discard("scale")
        for name, v in tree.items():
            if name in leaves:
                sd[f"{prefix}{name}"] = v
            elif isinstance(v, dict):
                walk(f"{prefix}{name}.", v)

    walk("", flax_params.get("params", flax_params))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
