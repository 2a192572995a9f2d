"""The frozen reference against the port (vaevar_tpu_torch) at micro sizes
on the CPU, in float32: the LGUnet in both variants (the rope one with its
full-grid stage on the flash path), Possloss and AdamW over three steps,
the reduced 3D-Var cost, the obs draws and the advance. The reference
itself imports nothing of the port."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

import pb_micro
import models
from reference import da as rda
from reference import lgunet as ref_lgunet
from reference import train as rtrain

SEED = 2 ** 31 + 5


def _pair(entry, role, seed=SEED):
    prog = models.program_model(entry, seed, role, "cpu")
    ref = models.reference_model(entry, seed, role, "cpu")
    return prog, ref


@pytest.mark.parametrize("role", ["decoder", "forecast"])
def test_lgunet_forward_matches_port(role):
    entry = pb_micro.micro_da_config()["models"][role]
    prog, ref = _pair(entry, role)
    assert sorted(dict(prog.named_parameters())) == sorted(dict(ref.named_parameters()))
    cin = sum(entry["inchans_list"])
    x = torch.randn(2, cin, *entry["img_size"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = prog(x), ref(x)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_lgunet_relbias_clamps_and_masks_as_port():
    """A relbias stage whose grid is no larger than its window (clamped,
    unshifted) next to shifted masked stages."""
    entry = dict(pb_micro.micro_da_config()["models"]["decoder"], img_size=[16, 64],
                 enc_depths=[2, 2], lg_depths=[2])
    prog, ref = _pair(entry, "decoder")
    x = torch.randn(1, sum(entry["inchans_list"]), 16, 64)
    with torch.no_grad():
        torch.testing.assert_close(prog(x), ref(x), rtol=1e-5, atol=1e-5)


def test_full_grid_attention_blocks_equal_dense(monkeypatch):
    q, k, v = (torch.randn(1, 2, 300, 16, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    ctx = ref_lgunet.Ctx()
    monkeypatch.setattr(ref_lgunet, "ATTN_BLOCK", 64)
    dense = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
    torch.testing.assert_close(ref_lgunet.full_attention(q, k, v, ctx), dense)


def test_train_steps_match_port():
    """Possloss and AdamW with the cosine schedule: three steps of the port's
    make_forecast_train_step against the reference's, same weights."""
    from vaevar_tpu_torch.train import forecast_trainer as ft

    entry = pb_micro.micro_train_config()["model"]
    prog, ref = _pair(entry, "forecast")
    hw = tuple(entry["img_size"])
    g = torch.Generator().manual_seed(2)
    frames = [torch.randn(1, 69, *hw, generator=g) for _ in range(4)]
    init_fn, step = ft.make_forecast_train_step(prog, "Possloss", lr=1e-3, total_steps=5,
                                                out_shape=(138, *hw))
    trainable, opt = init_fn()
    n = 69 * hw[0] * hw[1]
    mx = torch.nn.Parameter(torch.full((1, n), 0.5))
    mn = torch.nn.Parameter(torch.full((1, n), -10.0))
    params = [p for _, p in sorted(ref.named_parameters())] + [mx, mn]
    adam = rtrain.AdamW(params, 1e-3, 5)
    for i in range(3):
        trainable, opt, loss = step(trainable, opt, frames[i], [frames[i + 1]])
        for p in params:
            p.grad = None
        want = rtrain.possloss(ref(frames[i]), frames[i + 1], mx, mn)
        want.backward()
        adam.step()
        assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    got = dict(prog.named_parameters())
    for name, p in ref.named_parameters():
        # Adam divides by the gradient's size: an element whose gradient is
        # round-off moves by up to lr a step, on either side; one in a
        # thousand may, and none by more than 3 steps of 2 lr
        diff = (got[name] - p).detach().abs()
        assert float((diff > 1e-3 * 1e-3).float().mean()) <= 1e-3, name
        assert float(diff.max()) <= 6 * 1e-3, name
    torch.testing.assert_close(trainable["max_logvar"], mx, rtol=1e-5, atol=1e-7)


def test_cost_and_obs_match_port():
    """The obs draws, the reduced obs term, J of the port's reduced 3D-Var
    cost and its gradient, and the analysis state, against the reference's."""
    from vaevar_tpu_torch.da import cost as cost_mod
    from vaevar_tpu_torch.da.lbfgs import value_and_grad
    from vaevar_tpu_torch.da import obs as obs_mod

    cfg = pb_micro.micro_da_config()
    da = cfg["da"]
    hw, low = tuple(da["grid_hw"]), tuple(da["solver_hw"])
    prog, ref = _pair(cfg["models"]["decoder"], "decoder")
    prog.requires_grad_(False)
    rng = np.random.default_rng(SEED)
    masks = [obs_mod.make_obs_mask(da["obs_type"], 1, hw, rng) for _ in range(3)]
    draws = rda.column_draws(SEED, da["obs_type"], 3, hw)
    for m, cols in zip(masks, draws):
        assert np.array_equal(np.flatnonzero(m[0, 0]), cols)
        assert (m[0] == m[0, :1]).all()
    g = torch.Generator().manual_seed(3)
    truth = torch.randn(69, *hw, generator=g) * 10 + 100
    xb = truth + torch.randn(69, *hw, generator=g)
    var = obs_mod.obs_error_variance(da["obs_std"], da["modify_tp"])
    assert np.allclose(var, rda.obs_error_variance(da["obs_std"], da["modify_tp"]), rtol=1e-6)
    R = torch.as_tensor(obs_mod.build_R(var, None, 1))
    bundle = cost_mod.reduce_obs(cost_mod.ObsBundle(xb=xb, yo=truth[None],
                                                    H=torch.as_tensor(masks[1])[:1], R=R), low)
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_reduced(prog, 1.0)
    obs = rda.ObsTerm(truth, xb, draws[1], var, low)
    for z in (torch.zeros(1, 32, *low), 0.3 * torch.randn(1, 32, *low, generator=g)):
        e = rda.increment(ref, z)
        j_ref, jb_ref, jo_ref = rda.cost(z, e, obs)
        jb, jo = parts(z, bundle)
        assert float(cost(z, bundle)) == pytest.approx(j_ref, rel=1e-5)
        assert float(jo) == pytest.approx(jo_ref, rel=1e-5)
        assert float(jb) == pytest.approx(jb_ref, rel=1e-6)
        g = value_and_grad(lambda q: cost(q, bundle), z)[1]
        g_ref = rda.gradient(ref, z, obs)
        assert float((g - g_ref).norm() / (g_ref - z).norm()) < 1e-4
        torch.testing.assert_close(to_state(z, bundle), xb + rda.upsample(e, hw),
                                   rtol=1e-5, atol=1e-4)


def test_advance_matches_port():
    from vaevar_tpu_torch.da.dynamics import make_integrate

    cfg = pb_micro.micro_da_config()
    prog, ref = _pair(cfg["models"]["forecast"], "forecast")
    from reference import channels

    hw = tuple(cfg["da"]["grid_hw"])
    x = torch.as_tensor(channels.MEAN, dtype=torch.float32)[:, None, None] + torch.as_tensor(
        channels.STD, dtype=torch.float32)[:, None, None] * torch.randn(69, *hw)
    with torch.no_grad():
        got = make_integrate(prog)(x, 1, True)
    torch.testing.assert_close(got, rda.advance(ref, x), rtol=1e-5, atol=1e-3)


def test_fp8_control_rounds_products():
    x = torch.linspace(-3, 3, 1001)
    q = ref_lgunet.fp8(x)
    assert 0 < float((q - x).abs().max()) <= 3 / 16
    assert torch.equal(ref_lgunet.fp8(q), q)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import reference.lgunet, reference.da, reference.train, reference.channels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vaevar_tpu', 'vaevar_tpu_torch', 'jax', 'jaxlib', 'flax', 'optax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = pb_micro.HERE.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
