"""SD_attn's general path in the port against the JAX package: dilated token
groups and 3-D (T=1, H, W) windows with rope3, from the ops up to an LGUnet
whose 3-D windowed LG stage runs, and one train step.

Tolerances, with the reason:
- rope3_tables and sd_attention_mask: bitwise (the same numpy code).
- apply_rope3: rtol 1e-6 (the same f32 products; torch and XLA may fuse
  the multiply-add differently, one ulp).
- WindowAttention and the micro LGUnet forward: rtol 1e-4, atol 1e-5, and
  the input gradient of sum(out * g) to the same tolerance on the gradient's
  scale (f32, matmuls and layer norms summed in another order, as
  tests/test_torch_lgunet.py).
- bf16 forward: atol 2e-3 of outputs O(0.1) (one bf16 rounding the other
  way after f32 noise, as tests/test_torch_lgunet.py).
- the train step: tests/test_torch_train.py's tolerances (loss rtol 1e-5,
  gradients rtol 1e-3 and atol 1e-4 x max|grad|, parameters after each
  AdamW step atol 2.5 x lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity as parity
from test_torch_train import LR, _jax_in_port_layout, _port_trainable, _run_jax
from torch_port_util import model_pair, rand
from vaevar_tpu import config as C
from vaevar_tpu.models.lgunet import WindowAttention as JaxWindowAttention
from vaevar_tpu.ops import rope as jrope
from vaevar_tpu.ops import windows as jwin
from vaevar_tpu_torch import config as tcfg
from vaevar_tpu_torch.models.lgunet import LGUnet as TorchLGUnet
from vaevar_tpu_torch.models.lgunet import WindowAttention
from vaevar_tpu_torch.ops import flash_attn as fa
from vaevar_tpu_torch.ops import rope as trope
from vaevar_tpu_torch.ops import windows as twin
from vaevar_tpu_torch.train import forecast_trainer as tft

torch.set_num_threads(1)

SD = dict(window_size=(2, 2), lg_window_size=(1, 2, 4), dilated_size=(1, 1, 2))
# the micro SD model: the 3-D windowed LG stage 1 runs (lg_depths
# (1, 2)); at 16x64 the dilated total window (1, 2, 8) leaves two windows in
# longitude, so the shifted 3-D block is masked, and lg_depths (1, 3) takes
# the unscanned odd-depth stage (`blk{i}` in the flax tree); the train step's
# enc_depths (2, 1) runs a shifted, masked dilated encoder block
CONFIGS = {
    "sd_16x32": C.micro_config(img_size=(16, 32), lg_depths=(1, 2), lg_heads=(1, 1), **SD),
    "sd_16x64_odd_masked": C.micro_config(img_size=(16, 64), lg_depths=(1, 3),
                                          lg_heads=(1, 2), embed_dim=32, flash_min_seq=16,
                                          **SD),
}
TRAIN_CFG = C.micro_config(img_size=(16, 32), enc_depths=(2, 1), lg_depths=(1, 2),
                           lg_heads=(1, 1), flash_min_seq=16, remat=True,
                           inchans_list=(4, 13), outchans_list=(8, 26), **SD)


@pytest.mark.parametrize("shape, head_dim", [((1, 2, 4), 16), ((2, 3, 4), 12),
                                             ((1, 6, 12), 192), ((2, 2, 2), 20)])
def test_rope3_matches_jax(shape, head_dim):
    tables = trope.rope3_tables(shape, head_dim)
    for a, b in zip(tables, jrope.rope3_tables(shape, head_dim)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x = rand((3, 2, int(np.prod(shape)), head_dim), 1)
    want = np.asarray(jrope.apply_rope3(jnp.asarray(x), tables))
    got = trope.apply_rope3(torch.from_numpy(x), [torch.from_numpy(t) for t in tables])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # a bf16 x times the f32 tables comes out f32, as in JAX
    got16 = trope.apply_rope3(torch.from_numpy(x).bfloat16(), [torch.from_numpy(t) for t in tables])
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("name, grid, win, shift, dil", parity.TestSDAttnFullSurface.CASES,
                         ids=[c[0] for c in parity.TestSDAttnFullSurface.CASES])
def test_sd_attention_mask_matches_jax(name, grid, win, shift, dil):
    for neg in (-np.inf, -100.0):
        got = twin.sd_attention_mask(grid, win, shift, dil, neg=neg)
        want = jwin.sd_attention_mask(grid, win, shift, dil, neg=neg)
        assert (got is None) == (want is None) == (shift[-1] == 0), name
        if want is not None:
            np.testing.assert_array_equal(got, want)


def _check_forward_and_input_gradient(jm, params, tm, x, g):
    """Forward and the input gradient of sum(out * g), JAX (jitted) against
    the port, at the module docstring's tolerances."""
    y_j = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    gx_j = np.asarray(jax.jit(jax.grad(lambda z: jnp.sum(jm.apply(params, z) * g)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tm(xt)
    (y_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-4, atol=1e-5)
    scale = np.abs(gx_j).max()
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=1e-4, atol=1e-5 * scale)


# (grid, window, shift, dilated, lora rank): the general path's four kinds,
# 3-D dilated and shifted, and LoRA q
ATTN_CASES = {
    "2d-dilated": ((8, 16), (2, 4), (0, 0), (2, 2), 0),
    "2d-dilated-shift": ((8, 16), (2, 4), (1, 2), (2, 2), 0),
    "3d": ((1, 4, 16), (1, 2, 4), (0, 0, 0), (1, 1, 1), 0),
    "3d-shift": ((4, 8, 16), (2, 2, 4), (1, 1, 2), (1, 1, 1), 0),
    "3d-dilated-shift-lora": ((2, 8, 16), (1, 2, 2), (0, 1, 1), (1, 2, 2), 3),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_window_attention_general_matches_jax(name):
    grid, win, shift, dil, lora = ATTN_CASES[name]
    dim, heads = 24, 2
    jm = JaxWindowAttention(dim, heads, win, shift, grid, attn_type="rope", lora_rank=lora,
                            dilated_size=dil)
    x = rand((2, *grid, dim), 3)
    g = rand((2, *grid, dim), 4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # random LoRA factors: flax initialises qB to zero
    params = jax.tree.map(lambda a: np.asarray(a) + rand(a.shape, 5, 0.05), params)
    p = params["params"]
    tm = WindowAttention(dim, heads, win, shift, grid, "rope", lora, dilated_size=dil)
    sd = {f"{k}.weight": p[k]["kernel"].T for k in p}
    sd.update({f"{k}.bias": p[k]["bias"] for k in p if "bias" in p[k]})
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    assert tm.general

    _check_forward_and_input_gradient(jm, params, tm, x, g)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sd_lgunet_forward_and_input_gradient(name):
    cfg = CONFIGS[name]
    jm, params, tm = model_pair(cfg)
    assert any(isinstance(m, WindowAttention) and len(m.win) == 3
               for m in tm.net.layers[1].modules()), "the 3-D windowed LG stage is missing"
    x = rand((1, 69, *cfg.img_size), 5)
    g = rand((1, 138, *cfg.img_size), 6)
    _check_forward_and_input_gradient(jm, params, tm, x, g)


def test_sd_lgunet_forward_bf16():
    cfg = CONFIGS["sd_16x32"].replace(dtype=jnp.bfloat16)
    jm, params, tm = model_pair(cfg)
    x = rand((1, 69, *cfg.img_size), 7)
    y_j = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=2e-3)


def test_sd_train_step_matches_jax(monkeypatch):
    """One Possloss step through both trainers' make_forecast_train_step,
    with remat; the full-grid LG stage 0 runs flash attention's custom
    backward (its plain version here)."""
    cfg = TRAIN_CFG
    jm, params, tm = model_pair(cfg)
    hw, nc = cfg.img_size, sum(cfg.inchans_list)
    batch = (rand((1, nc, *hw), 10), [rand((1, nc, *hw), 11)])
    j_losses, j_grads, j_states = _run_jax(jm, params, "Possloss", [batch])

    bwd_calls = []
    real = fa.flash_attention_bwd_plain
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a: bwd_calls.append(1) or real(*a))
    init_fn, step = tft.make_forecast_train_step(
        tm.train(), "Possloss", lr=LR, total_steps=4, out_shape=(2 * nc, *hw))
    trainable, opt_state = init_fn()
    trainable, opt_state, loss = step(trainable, opt_state, torch.from_numpy(batch[0]),
                                      [torch.from_numpy(t) for t in batch[1]])
    assert bwd_calls, "the flash stage's backward did not run"
    t_grads = {f"model.{k}": p.grad.numpy() for k, p in trainable["model"].named_parameters()}
    t_grads.update({k: v.grad.numpy() for k, v in trainable.items() if k != "model"})

    np.testing.assert_allclose(float(loss), j_losses[0], rtol=1e-5)
    want = _jax_in_port_layout(j_grads, cfg)
    assert sorted(want) == sorted(t_grads)
    scale = max(np.abs(g).max() for g in want.values())
    for k in want:
        np.testing.assert_allclose(t_grads[k], want[k], rtol=1e-3, atol=1e-4 * scale, err_msg=k)
    got = _port_trainable(trainable)
    for k, v in _jax_in_port_layout(j_states[0], cfg).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2.5 * LR, err_msg=k)


@pytest.mark.parametrize("dilated", [(2, 2), (1, 2)])
def test_two_entry_dilation_with_3d_lg_window_is_refused(dilated):
    """JAX cannot run a 2-entry dilation against a 3-D LG window (a
    TypeError in _call_general's reshape); the port refuses it when the
    model is built, naming both fields."""
    kw = dict(img_size=(16, 32), window_size=(2, 2), lg_window_size=(1, 2, 4),
              dilated_size=dilated, lg_depths=(1, 2), lg_heads=(1, 1))
    jm_cfg = C.micro_config(**kw)
    x = jnp.zeros((1, 69, 16, 32))
    with pytest.raises(TypeError):
        from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
        jax.eval_shape(JaxLGUnet(jm_cfg).init, jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="dilated_size.*lg_window_size"):
        TorchLGUnet(tcfg.micro_config(**kw))


def test_forecast_sd_variant_builds_and_runs():
    """FORECAST_025's SD variant (lg_window_size (1, 6, 12), dilated_size
    (1, 1, 3)) at a small grid and narrow widths: it runs the 3-D windows in
    LG stages 1-2 and dilated windows in every encoder and decoder stage, has
    FORECAST_025's parameters (the SD path adds no weight), and with the same
    weights computes another function."""
    small = dict(img_size=(145, 288), enc_dim=8, embed_dim=48, enc_heads=(1, 2, 2),
                 lg_heads=(2, 2, 2))
    base = tcfg.FORECAST_025.replace(**small)
    sd = base.replace(lg_window_size=(1, 6, 12), dilated_size=(1, 1, 3))
    model = TorchLGUnet(sd)
    attns = [m for m in model.modules() if isinstance(m, WindowAttention)]
    assert sum(len(m.win) == 3 for m in attns) == sum(sd.lg_depths[1:])
    assert sum(m.dil == (1, 3) for m in attns) == 2 * 6 * sum(sd.enc_depths)
    base_model = TorchLGUnet(base)
    assert [(n, p.shape) for n, p in model.named_parameters()] == \
        [(n, p.shape) for n, p in base_model.named_parameters()]
    base_model.load_state_dict(model.state_dict())
    x = torch.from_numpy(rand((1, 69, 145, 288), 1))
    with torch.no_grad():
        y, y_base = model(x), base_model(x)
    assert y.shape == (1, 138, 145, 288) and bool(torch.isfinite(y).all())
    assert not torch.equal(y, y_base), "the SD path computed FORECAST_025's function"
