"""The port's fast_init draws the JAX package's weights, bit for bit.

vaevar_tpu_torch/utils/fast_init.py replays vaevar_tpu/utils/fast_init.py
without jax: the flax tree's leaves in jax's flatten order (sorted keys),
`(scale * rng.standard_normal(shape)).astype(float32)` each, mapped onto the
module through utils/port_jax.py. Here every model family a CLI builds with
--fast_init (LGUnet relbias with and without LoRA and with odd shifted
depths, rope with and without a full-attention first stage, the SD variant
with 3-D windows and dilation, uniform and per-group upper-air groups, the
micro VAE pairs) is drawn by both packages for several seeds and scales and
must agree exactly, parameter by parameter; with the leaf order reversed it
must not (the order is what makes the values JAX's). run_da.build_model
builds without torch's default initialisation, and its models are bitwise
those of a default build filled the same way.

The slow test holds the full-width weights of JAX run_da's three roles
(run_da.py:269-320: VAE_DECODER from --seed 0, FLOW_140 from seed 1,
FORECAST_025 from seed 2) to tests/goldens/torch_fast_init_sha256.json:
JAX's draw through the bridge, and the port's own. chip_smoke.py's pinned
phase checks the same digests on the models the port's run_da builds on the
card. Write the file anew with `python tests/test_torch_fast_init.py write`
(one numpy draw per model; ~4 GB of host memory at the peak).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaevar_tpu import config as C
from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
from vaevar_tpu.models.vae import VAE as JaxVAE
from vaevar_tpu.utils.fast_init import fast_init as jax_fast_init
from vaevar_tpu_torch import config as TC
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.models.vae import VAE
from vaevar_tpu_torch.models.zoo import GatedMlp
from vaevar_tpu_torch.utils import fast_init as fi
from vaevar_tpu_torch.utils.port_jax import lgunet_state_dict_from_flax, vae_state_dict_from_flax

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_fast_init_sha256.json"

_MICRO_VAE6 = C.micro_config(img_size=(32, 64), attn_type="relbias")
CONFIGS = {
    "relbias": C.micro_config(img_size=(32, 64), attn_type="relbias"),
    "rope": C.micro_config(img_size=(32, 64)),
    "rope_full_attn_first": C.micro_config(img_size=(32, 64), lg_full_attn_first=True),
    "sd_3d_dilated": C.micro_config(img_size=(32, 64), lg_window_size=(1, 2, 4),
                                    dilated_size=(1, 1, 2)),
    "tiny_rope_uniform_groups": C.tiny_config(),
    "relbias_lora_odd_depths": C.micro_config(
        img_size=(16, 32), attn_type="relbias", lora_rank=2, enc_depths=(4, 1),
        lg_depths=(3, 2), lg_heads=(1, 1)),
    "vae_micro": C.micro_vae_configs(img_size=(32, 64)),
    "vae_micro_six_groups": (_MICRO_VAE6.replace(outchans_list=(4, 12, 12, 12, 12, 12)),
                             _MICRO_VAE6.replace(inchans_list=(2, 6, 6, 6, 6, 6),
                                                 outchans_list=(4, 13, 13, 13, 13, 13))),
}
DRAWS = [(0, 0.02), (3, 0.02), (0, 0.3)]


def _jax_state_dict(cfg, seed, scale):
    """JAX fast_init's tree of `cfg` (an LGUnet config, or an (enc, dec)
    pair for the VAE), through the bridge."""
    if isinstance(cfg, tuple):
        enc, dec = cfg
        x = jnp.zeros((1, sum(enc.inchans_list), *enc.img_size), jnp.float32)
        tree = jax_fast_init(JaxVAE(enc, dec), x, jax.random.PRNGKey(0), seed=seed, scale=scale)
        return vae_state_dict_from_flax(jax.tree.map(np.asarray, tree), enc, dec)
    x = jnp.zeros((1, sum(cfg.inchans_list), *cfg.img_size), jnp.float32)
    tree = jax_fast_init(JaxLGUnet(cfg), x, seed=seed, scale=scale)
    return lgunet_state_dict_from_flax(jax.tree.map(np.asarray, tree), cfg)


def _port_model(cfg):
    return VAE(*cfg) if isinstance(cfg, tuple) else LGUnet(cfg)


def _n_equal(sd, model):
    params = dict(model.named_parameters())
    assert set(params) == set(sd)
    return sum(torch.equal(params[k], sd[k]) for k in params), len(params)


@pytest.mark.parametrize("seed, scale", DRAWS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fast_init_is_jax_draw_bitwise(name, seed, scale):
    cfg = CONFIGS[name]
    model = _port_model(cfg)
    before = {k: p.clone() for k, p in model.named_parameters()}
    assert fi.fast_init(model, seed=seed, scale=scale) is model
    equal, n = _n_equal(_jax_state_dict(cfg, seed, scale), model)
    assert equal == n, f"{n - equal} of {n} parameters differ from JAX's draw"
    # every parameter was written: none kept torch's default initialisation
    changed = sum(not torch.equal(before[k], p) for k, p in model.named_parameters())
    assert changed == n


@pytest.mark.parametrize("name", ["relbias", "vae_micro"])
def test_leaf_order_is_what_makes_the_draw_jax(name, monkeypatch):
    """Mutation check: the same draws in the reversed leaf order fill the
    same shapes, and differ from JAX's almost everywhere."""
    cfg = CONFIGS[name]
    ref = _jax_state_dict(cfg, 0, 0.02)
    order = fi.flax_leaf_order
    monkeypatch.setattr(fi, "flax_leaf_order", lambda tree: reversed(list(order(tree))))
    equal, n = _n_equal(ref, fi.fast_init(_port_model(cfg), seed=0))
    assert equal < n // 10


def test_flax_layout_is_jax_tree():
    """The shape tree the port lays out is jax.eval_shape's, key for key."""
    for cfg in (CONFIGS["relbias_lora_odd_depths"], CONFIGS["tiny_rope_uniform_groups"]):
        x = jnp.zeros((1, sum(cfg.inchans_list), *cfg.img_size), jnp.float32)
        shapes = jax.eval_shape(lambda a: JaxLGUnet(cfg).init(jax.random.PRNGKey(0), a), x)
        ref = [(tuple(getattr(k, "key", k) for k in path), leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)]
        assert list(fi.flax_leaf_order(fi.lgunet_flax_shapes(LGUnet(cfg)))) == ref


def test_other_modules_are_refused():
    with pytest.raises(TypeError, match="LGUnet and VAE"):
        fi.fast_init(GatedMlp(8, (2, 2)))


def _tensors(model):
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@pytest.mark.parametrize("fill", ["fast_init", "flax_init", "checkpoint"])
@pytest.mark.parametrize("name", ["relbias_lora_odd_depths", "sd_3d_dilated"])
def test_build_without_default_init_is_the_default_build(name, fill, tmp_path):
    """run_da.build_model builds its models without torch's default
    initialisation (models/init.py::without_default_init): after the fill,
    every parameter and buffer is bitwise what a default-initialised build
    filled the same way holds, for each of the three fills."""
    from vaevar_tpu_torch.models.init import init_like_flax
    from vaevar_tpu_torch.run_da import build_model
    from vaevar_tpu_torch.train.checkpoint import save

    cfg = CONFIGS[name]
    ref = LGUnet(cfg)
    if fill == "flax_init":
        init_like_flax(ref, torch.Generator().manual_seed(5))
    else:
        fi.fast_init(ref, seed=5 if fill == "fast_init" else 9)
    path = tmp_path / "ckpt.pt"
    save(str(path), ref.state_dict())
    linear_init = torch.nn.Linear.reset_parameters
    got = build_model(cfg, 5, "cpu", fast=fill == "fast_init",
                      ckpt_path=str(path) if fill == "checkpoint" else None)
    assert torch.nn.Linear.reset_parameters is linear_init  # restored after the build
    want, have = _tensors(ref), _tensors(got)
    assert set(want) == set(have)
    assert all(torch.equal(want[k], have[k]) for k in want)


def test_without_default_init_restores_the_default_after_the_block():
    from vaevar_tpu_torch.models.init import without_default_init

    with pytest.raises(RuntimeError, match="inside"):
        with without_default_init():
            torch.nn.LayerNorm(4)
            raise RuntimeError("inside")
    assert bool((torch.nn.LayerNorm(4).weight == 1).all())  # the default again


# --- full width (slow): the digests of JAX run_da's three roles -------------

def _roles():
    """(role, JAX config, input shape, seed): JAX run_da's fast_init calls
    of the README cycle (run_da.py:269-320) and of its window (the flow)."""
    return [("VAE_DECODER", C.VAE_DECODER, (1, 32, 128, 256), 0),
            ("FLOW_140", C.FLOW_140, (1, 69, 128, 256), 1),
            ("FORECAST_025", C.FORECAST_025, (1, 69, 721, 1440), 2)]


def _jax_digests():
    out = {}
    for role, cfg, shape, seed in _roles():
        tree = jax_fast_init(JaxLGUnet(cfg), jnp.zeros(shape, jnp.float32), seed=seed)
        sd = lgunet_state_dict_from_flax(jax.tree.map(np.asarray, tree), cfg)
        del tree
        out[role] = {"seed": seed, "input": list(shape), "sha256": fi.param_digests(sd)}
    return out


@pytest.mark.slow
def test_full_width_digests_match_jax():
    golden = json.loads(GOLDEN.read_text())
    jax_digests = _jax_digests()
    for role, cfg, _, seed in _roles():
        want = golden[role]["sha256"]
        assert jax_digests[role]["sha256"] == want, role
        port = fi.fast_init(LGUnet(getattr(TC, role)), seed=seed)
        assert fi.param_digests(dict(port.named_parameters())) == want, role
        del port


if __name__ == "__main__" and sys.argv[1:] == ["write"]:
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.write_text(json.dumps(_jax_digests(), indent=0, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}")
