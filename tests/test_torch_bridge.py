"""Weight bridge: flax params -> port state_dict -> flax params, bit for bit.

`lgunet_state_dict_from_flax` must be the exact inverse of
vaevar_tpu/utils/port_torch.py::lgunet_params_from_torch, and the port's
module tree must carry the reference torch key names: a strict load of the
bridged dict, then port_torch over the port's own state_dict, gives back
the original tree with identical arrays. This is also the live check of
port_torch on a host without the reference checkpoints."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flax_params, rand
from vaevar_tpu import config as C
from vaevar_tpu.utils import port_torch
from vaevar_tpu_torch.models.lgunet import LGUnet, conv_transpose_valid
from vaevar_tpu_torch.utils.port_jax import _convT, lgunet_state_dict_from_flax

torch.set_num_threads(1)


def _assert_tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


CONFIGS = {
    "micro_vae_decoder_relbias": C.micro_vae_configs()[1],
    "tiny_rope_uniform_groups": C.tiny_config(),
    "micro_relbias_lora_depth4": C.micro_config(
        img_size=(16, 32), attn_type="relbias", lora_rank=2, enc_depths=(4, 1),
        lg_depths=(3, 2), lg_heads=(1, 1)),
    "micro_rope_patch32_odd_height": C.micro_config(
        img_size=(33, 64), patch_size=(3, 2), enc_depths=(2, 2, 2),
        enc_heads=(1, 1, 1), lg_depths=(4, 2), lg_heads=(2, 2)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_round_trip_is_identity(name):
    cfg = CONFIGS[name]
    params = flax_params(cfg, seed=3)
    model = LGUnet(cfg)
    model.load_state_dict(lgunet_state_dict_from_flax(params, cfg), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_tree_equal(port_torch.lgunet_params_from_torch(sd, cfg), params)


def test_conv_transpose_matches_flax_at_odd_height():
    """flax ConvTranspose(VALID) with kernel (3, 2), stride 2 maps 16 rows
    to 33 (360 -> 721 in FORECAST_025); the port's transposed conv with the
    bridged (flipped) kernel gives the same output."""
    x = rand((1, 16, 20, 5), 0)
    layer = fnn.ConvTranspose(7, kernel_size=(3, 2), strides=(2, 2), padding="VALID")
    params = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["bias"] = rand((7,), 1)
    y_j = np.asarray(layer.apply(params, jnp.asarray(x)))
    ct = torch.nn.ConvTranspose2d(5, 7, (3, 2), (2, 2))
    with torch.no_grad():
        ct.weight.copy_(torch.from_numpy(np.ascontiguousarray(_convT(params["params"]["kernel"]))))
        ct.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        y_t = conv_transpose_valid(torch.from_numpy(x), ct).numpy()
    assert y_t.shape == y_j.shape == (1, 33, 40, 7)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-6)
