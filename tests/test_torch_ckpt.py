"""Model weights of the port against the JAX package: the VAE and its
bridge, the flax-matched init, and both checkpoint converters.

- The VAE bridge (`vae_state_dict_from_flax`) inverts
  `port_torch.vae_params_from_torch` bit for bit, and the port's VAE with
  bridged weights computes the JAX VAE's encoder, decoder and decoder_hr
  (rtol 1e-4, atol 1e-5, test_torch_lgunet.py's f32 tolerance) and ELBO
  (rtol 1e-5: a few f32 sums).
- `init_like_flax` draws from the distributions of `LGUnet.init`: per
  parameter the same shape, exact zeros and ones where flax has them, and
  per initializer (`_trunc02`, `lecun_normal` scaled by its fan_in) a pooled
  std within 5 standard errors of JAX's and no entry past the truncation.
- `python -m vaevar_tpu_torch.convert_ckpt` against scripts/convert_ckpt.py
  on reference-layout `.pth` files (wrappers, `module.` prefixes, logvar
  buffers) built from port modules: the port checkpoint holds the file's
  weights bit for bit and its forward equals the flax forward of the JAX
  conversion at test_torch_lgunet.py's tolerance.
- scripts/orbax_to_torch.py: JAX-written orbax trees become port
  checkpoints equal to the bridge's state_dicts, bit for bit.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flax_params, rand
from vaevar_tpu import config as C
from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
from vaevar_tpu.models.vae import VAE as JaxVAE
from vaevar_tpu.models.vae import elbo_loss as jax_elbo
from vaevar_tpu.train import checkpoint as orbax_ckpt
from vaevar_tpu.utils import port_torch
from vaevar_tpu_torch import convert_ckpt
from vaevar_tpu_torch.models.init import init_like_flax, lecun_std
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.models.vae import VAE, elbo_loss
from vaevar_tpu_torch.train import checkpoint as ckpt
from vaevar_tpu_torch.utils.fast_init import fast_init
from vaevar_tpu_torch.utils.port_jax import lgunet_state_dict_from_flax, vae_state_dict_from_flax

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import convert_ckpt as jax_convert  # noqa: E402  scripts/convert_ckpt.py
import orbax_to_torch  # noqa: E402

VAE_HW = (32, 64)


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def vae_pair():
    """(JAX VAE, its params, port VAE): one set of random weights."""
    enc_cfg, dec_cfg = C.micro_vae_configs(img_size=VAE_HW)
    port = fast_init(VAE(enc_cfg, dec_cfg), seed=4).eval()
    params = port_torch.vae_params_from_torch(_np_sd(port), enc_cfg, dec_cfg)
    return JaxVAE(enc_cfg, dec_cfg), params, port


def test_vae_bridge_round_trip(vae_pair):
    _, params, port = vae_pair
    enc_cfg, dec_cfg = C.micro_vae_configs(img_size=VAE_HW)
    sd = vae_state_dict_from_flax(params, enc_cfg, dec_cfg)
    _assert_sd_equal({k: v.numpy() for k, v in sd.items()}, _np_sd(port))
    assert all(k.startswith(("enc.", "dec.")) for k in sd)
    VAE(enc_cfg, dec_cfg).load_state_dict(sd, strict=True)


def test_vae_matches_jax(vae_pair, monkeypatch):
    jvae, params, port = vae_pair
    x = rand((1, 69, *VAE_HW), 1)
    z = rand((1, 8, *VAE_HW), 2)

    def close(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    mu_j, logvar_j = jvae.apply(params, jnp.asarray(x), method=JaxVAE.encoder)
    with torch.no_grad():
        mu_t, logvar_t = port.encoder(torch.from_numpy(x))
        close(mu_t, mu_j)
        close(logvar_t, logvar_j)
        close(port.decoder(torch.from_numpy(z)),
              jvae.apply(params, jnp.asarray(z), method=JaxVAE.decoder))
        hr_t = port.decoder_hr(torch.from_numpy(z), (47, 93))
        close(hr_t, jvae.apply(params, jnp.asarray(z), (47, 93), method=JaxVAE.decoder_hr))
        assert hr_t.shape == (1, 69, 47, 93)

        # the whole VAE with one fixed eps on both sides: the port draws it
        # from its generator, the JAX VAE gets the same array from rng
        eps = torch.randn(mu_t.shape, generator=torch.Generator().manual_seed(7))
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(
            eps.numpy(), dtype))
        recon_j, mu_j, logvar_j = jvae.apply(params, jnp.asarray(x), jax.random.PRNGKey(0))
        recon_t, mu_t, logvar_t = port(torch.from_numpy(x), torch.Generator().manual_seed(7))
    close(recon_t, recon_j)
    want = [float(v) for v in jax_elbo(recon_j, jnp.asarray(x), mu_j, logvar_j, sigma=2.0)]
    got = [float(v) for v in elbo_loss(*(torch.tensor(np.asarray(a)) for a in (
        recon_j, x, mu_j, logvar_j)), sigma=2.0)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        [float(v) for v in elbo_loss(recon_t, torch.from_numpy(x), mu_t, logvar_t, 2.0)],
        want, rtol=1e-4)


INIT_CONFIGS = {
    "micro_relbias_lora": C.micro_config(img_size=(32, 64), attn_type="relbias", lora_rank=2),
    "micro_rope": C.micro_config(img_size=(32, 64)),
}


def _init_scale(key, shape):
    """(initializer, the std its entries are divided by): lecun_normal for
    the patch-embedding conv (out, in, kh, kw) and the transposed-conv heads
    (in, out, kh, kw), fan_in = in * kh * kw; _trunc02 otherwise."""
    if key.endswith("patch_embed.proj.weight"):
        return "lecun", lecun_std(shape[1] * shape[2] * shape[3])
    if ".final_proj_list." in key and key.endswith(".weight"):
        return "lecun", lecun_std(shape[0] * shape[2] * shape[3])
    return "trunc02", 0.02


@pytest.mark.parametrize("name", sorted(INIT_CONFIGS))
def test_init_like_flax_matches_flax_distributions(name):
    cfg = INIT_CONFIGS[name]
    x = jnp.zeros((1, 69, *cfg.img_size), jnp.float32)
    want = {k: v.numpy() for k, v in lgunet_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(JaxLGUnet(cfg).init)(jax.random.PRNGKey(0), x)), cfg).items()}
    got = _np_sd(init_like_flax(LGUnet(cfg), torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    pools = {"trunc02": ([], []), "lecun": ([], [])}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not w.any():
            assert not g.any(), k
        elif (w == 1).all():
            assert (g == 1).all(), k
        else:
            kind, scale = _init_scale(k, w.shape)
            for pool, a in zip(pools[kind], (g, w)):
                pool.append(a.ravel() / scale)
    assert any(k.endswith("qB.weight") for k in want) == (cfg.lora_rank > 0)
    for kind, (g, w) in pools.items():
        g, w = np.concatenate(g), np.concatenate(w)
        # the std of n draws has a standard error of at most std / sqrt(2n)
        # for a normal truncated at 2 std (its kurtosis is below 3)
        se = np.hypot(g.std() / np.sqrt(2 * g.size), w.std() / np.sqrt(2 * w.size))
        assert abs(g.std() - w.std()) < 5 * se, (kind, g.std(), w.std(), se)
        assert np.abs(g).max() <= 2.0 + 1e-6 and np.abs(w).max() <= 2.0 + 1e-6, kind
        assert 0.85 < g.std() < 0.91, (kind, g.std())  # 0.8796 for the truncated unit normal


def _reference_pth(kind, path, seed=3):
    """A reference-layout .pth for `kind`, built from port modules with
    random weights: the forecast wrapper {"model": {"lgunet_all": ...}} and
    the flow wrapper {"model": ...} with `module.` prefixes and logvar
    buffers, the VAE as a bare state_dict. Returns the bare weights."""
    cfg = convert_ckpt.model_config(kind, micro=True)
    model = fast_init(VAE(*cfg) if kind == "vae" else LGUnet(cfg), seed=seed)
    sd = model.state_dict()
    bounds = {"max_logvar": torch.ones(1, 69), "min_logvar": -torch.ones(1, 69)}
    if kind == "forecast":
        obj = {"model": {"lgunet_all": {"module." + k: v for k, v in {**sd, **bounds}.items()}},
               "optimizer": {"state": {}}, "epoch": 3}
    elif kind == "flow":
        obj = {"model": {**{"module." + k: v for k, v in sd.items()}, **bounds}, "epoch": 7}
    else:
        obj = sd
    torch.save(obj, path)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["forecast", "flow", "vae"])
def test_convert_cli_matches_jax_convert(kind, tmp_path, capsys):
    src, out = tmp_path / "ref.pth", tmp_path / "port.pt"
    weights = _reference_pth(kind, src)
    convert_ckpt.main([kind, str(src), str(out), "--micro"])
    assert f"converted {kind}" in capsys.readouterr().out
    converted = ckpt.restore(str(out))
    _assert_sd_equal({k: v.numpy() for k, v in converted.items()}, weights)

    flax_tree = jax_convert.convert(kind, dict(weights), micro=True)
    cfg = convert_ckpt.model_config(kind, micro=True)
    if kind == "vae":
        port = VAE(*cfg).eval()
        port.load_state_dict(converted, strict=True)
        z = rand((1, 8, *cfg[1].img_size), 5)
        want = JaxVAE(*cfg).apply(flax_tree, jnp.asarray(z), method=JaxVAE.decoder)
        # run_da's decoder from the converted full VAE
        port = ckpt.load_weights(LGUnet(cfg[1]), str(out), vae=True).eval()
        x = z
    else:
        port = ckpt.load_weights(LGUnet(cfg), str(out)).eval()
        x = rand((1, 69, *cfg.img_size), 5)
        # run_da also reads a reference .pth that holds only tensors as is
        _assert_sd_equal(_np_sd(ckpt.load_weights(LGUnet(cfg), str(src))), weights)
        want = jax.jit(JaxLGUnet(cfg).apply)(flax_tree, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)

    # a file of another architecture fails the strict load
    other = {"forecast": "flow", "flow": "forecast", "vae": "flow"}[kind]
    with pytest.raises(RuntimeError, match="state_dict"):
        convert_ckpt.main([other, str(src), str(tmp_path / "wrong.pt"), "--micro"])


@pytest.mark.parametrize("kind, layout", [("forecast", "wrapped"), ("flow", "bare"),
                                          ("vae", "full"), ("vae", "decoder")])
def test_orbax_to_torch_equals_the_bridge(kind, layout, tmp_path):
    cfg = convert_ckpt.model_config(kind, micro=True)
    if kind == "vae":
        enc, dec = (flax_params(c, seed=s)["params"] for c, s in zip(cfg, (1, 2)))
        tree = ({"params": {"enc": enc, "dec": dec}} if layout == "full"
                else {"params": dec})
        want = (vae_state_dict_from_flax(tree, *cfg) if layout == "full"
                else lgunet_state_dict_from_flax(tree, cfg[1]))
    else:
        params = flax_params(cfg, seed=3)
        tree = params if layout == "wrapped" else params["params"]
        want = lgunet_state_dict_from_flax(params, cfg)
    orbax_ckpt.save(str(tmp_path / "orbax"), tree)
    out = tmp_path / "port.pt"
    orbax_to_torch.main([kind, str(tmp_path / "orbax"), str(out), "--micro"])
    got = ckpt.restore(str(out))
    _assert_sd_equal({k: v.numpy() for k, v in got.items()},
                     {k: v.numpy() for k, v in want.items()})
    model = VAE(*cfg) if layout == "full" else LGUnet(cfg[1] if kind == "vae" else cfg)
    model.load_state_dict(got, strict=True)
