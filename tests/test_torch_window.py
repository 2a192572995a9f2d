"""The port's 4D-Var window costs against the JAX package.

Micro relbias decoder and micro relbias flow model (FLOW_140's attention
branch) with bridged weights, on a solver grid of 16x32 under a 47x93
analysis grid: the ratios are not integers, so the resampling gather
S = down o up is a real gather, as at 721x1440 over 128x256. Inputs come
from numpy seeds; da_win 3.

Tolerances:
- `_resample_gather` exact (integer index tables);
- `reduce_obs_window` rtol 1e-5 on a, c and ybar where a > 0 (f32 sums
  over the full-resolution cells of each solver cell in another order);
  ybar also gets a floor of 1e-6 x (|mean| + std) of its channel, ~8 ulps
  of the state: slot 0's ybar is yo - xb, near zero where the two states
  cancel, and rounds at their magnitude (observed 4.2e-7 absolute);
- J rtol 1e-5 and dJ/dz at atol 1e-5 x max|dJ/dz| (as
  tests/test_torch_cost_lbfgs.py: f32 through the decoder and two flow
  steps in another summation order);
- the full windowed cost against the reduced one: the bounds of
  tests/test_da_engine.py::TestReducedWindowCost (J rel 1e-5, Jo rtol
  1e-5, Jb rtol 1e-6, the analysis atol 1e-5, the gradient's median
  elementwise rel 1e-5 and norm-relative 5e-4: the cell-mean ybar rounds
  at 1e-7 relative, amplified where the innovation is tiny);
- step checkpointing is a recompute: J bitwise equal, dJ/dz norm-rel 1e-5;
- at da_win 1 the window cost is the 3D-Var reduced cost written in the
  cell-centred form: J and dJ/dz rtol 1e-5 (the two forms round apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import model_pair, rand, to_np
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da import cost as jcost
from vaevar_tpu_torch.da import cost as tcost
from vaevar_tpu_torch.da import lbfgs as tlbfgs

torch.set_num_threads(1)
LOW, FULL, WIN = (16, 32), (47, 93), 3
RTOL = 1e-5


def _bundle_np(da_win, seed=0):
    rr = np.random.default_rng(seed)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    xb = (m + s * rr.normal(size=(69, *FULL))).astype(np.float32)
    yo = (m[None] + s[None] * rr.normal(size=(da_win, 69, *FULL))).astype(np.float32)
    H = (rr.random((da_win, 69, *FULL)) < 0.3).astype(np.float32)
    R = (s[None] ** 2 * (0.5 + rr.random((da_win, 69, *FULL)))).astype(np.float32)
    return xb, yo, H, R


def _bundles(da_win=WIN):
    arrs = _bundle_np(da_win)
    return (jcost.ObsBundle(*map(jnp.asarray, arrs)),
            tcost.ObsBundle(*map(torch.from_numpy, arrs)))


@pytest.fixture(scope="module")
def models():
    jdec, pdec, tdec = model_pair(C.micro_vae_configs(img_size=LOW)[1], seed=1)
    jflow, pflow, tflow = model_pair(C.micro_config(img_size=LOW, attn_type="relbias"), seed=2)
    for m in (tdec, tflow):
        m.requires_grad_(False)
    return dict(jdec=jdec.apply, jflow=jflow.apply, params={"decoder": pdec, "flow": pflow},
                tdec=tdec, tflow=tflow)


@pytest.fixture(scope="module")
def reduced():
    jb, tb = _bundles()
    return jcost.reduce_obs_window(jb, LOW), tcost.reduce_obs_window(tb, LOW)


@pytest.fixture(scope="module")
def jax_window(models):
    """(value_and_grad, cost_parts) of JAX's reduced window cost."""
    jc, _, jparts = jcost.make_vae4dvar_cost_window_reduced(
        models["jdec"], models["jflow"], da_win=WIN, obs_coeff=1.3)
    return _jax_vg(jc, models["params"]), jax.jit(lambda q, b: jparts(q, b, models["params"]))


def _z(scale, seed=11):
    return rand((1, 8, *LOW), seed, scale)


def _jax_vg(cost, params):
    """One jitted value_and_grad of a JAX cost (compiled once per shape)."""
    vg = jax.jit(jax.value_and_grad(lambda q, b: cost(q, b, params)))
    return lambda z, bundle: vg(jnp.asarray(z), bundle)


def _port_vg(cost, z, bundle):
    return tlbfgs.value_and_grad(lambda q: cost(q, bundle), torch.from_numpy(z))


def _close_grad(gt, gj):
    gj = np.asarray(gj)
    np.testing.assert_allclose(to_np(gt), gj, rtol=RTOL, atol=RTOL * np.abs(gj).max())


@pytest.mark.parametrize("n_full, n_low", [(47, 16), (93, 32), (721, 128), (1440, 256),
                                           (64, 32), (32, 32)])
def test_resample_gather_exact(n_full, n_low):
    np.testing.assert_array_equal(tcost._resample_gather(n_full, n_low),
                                  jcost._resample_gather(n_full, n_low))


def test_reduce_obs_window(reduced):
    jr, tr = reduced
    a = np.asarray(jr.a)
    assert (a > 0).any() and (a == 0).any()
    np.testing.assert_allclose(to_np(tr.a), a, rtol=RTOL)
    np.testing.assert_allclose(to_np(tr.c), np.asarray(jr.c), rtol=RTOL)
    # ybar near 0 (slot 0 holds yo - xb): f32 round-off of the state's
    # magnitude, ~8 ulps of |MEAN| + STD per channel
    floor = np.broadcast_to(1e-6 * (np.abs(channels.MEAN) + channels.STD).reshape(1, -1, 1, 1),
                            a.shape)
    np.testing.assert_array_less(np.abs(to_np(tr.ybar) - np.asarray(jr.ybar))[a > 0],
                                 (RTOL * np.abs(np.asarray(jr.ybar)) + floor)[a > 0])
    np.testing.assert_array_equal(to_np(tr.ybar)[a == 0], 0.0)
    np.testing.assert_array_equal(to_np(tr.xb_low), np.asarray(jr.xb_low))


@pytest.mark.parametrize("zscale", [0.0, 1.0])
def test_window_cost_and_gradient(models, reduced, jax_window, zscale):
    jr, tr = reduced
    jvg, jparts = jax_window
    tc, _, tparts = tcost.make_vae4dvar_cost_window_reduced(
        models["tdec"], models["tflow"], da_win=WIN, obs_coeff=1.3)
    z = _z(zscale)
    vj, gj = jvg(z, jr)
    vt, gt = _port_vg(tc, z, tr)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    _close_grad(gt, gj)
    for a, b in zip(tparts(torch.from_numpy(z), tr), jparts(jnp.asarray(z), jr)):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=1e-6)


def test_full_window_cost_matches_jax_and_reduced(models, reduced):
    jb, tb = _bundles()
    kw = dict(flow_hw=LOW, da_win=WIN, obs_coeff=1.3)
    jc, jts, jparts = jcost.make_vae4dvar_cost(models["jdec"], models["jflow"], **kw)
    tc, tts, tparts = tcost.make_vae4dvar_cost(models["tdec"], models["tflow"], **kw)
    z = _z(0.1)
    vj, gj = _jax_vg(jc, models["params"])(z, jb)
    vt, gt = _port_vg(tc, z, tb)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    _close_grad(gt, gj)

    # the port's full form against its reduced form
    rc, rts, rparts = tcost.make_vae4dvar_cost_window_reduced(
        models["tdec"], models["tflow"], da_win=WIN, obs_coeff=1.3)
    tr = reduced[1]
    vr, gr = _port_vg(rc, z, tr)
    assert abs(vt - vr) / abs(vt) < 1e-5, (vt, vr)
    zt = torch.from_numpy(z)
    with torch.no_grad():
        np.testing.assert_allclose(to_np(tts(zt, tb)), to_np(rts(zt, tr)), atol=1e-5)
        (jb_f, jo_f), (jb_r, jo_r) = tparts(zt, tb), rparts(zt, tr)
    np.testing.assert_allclose(float(jo_r), float(jo_f), rtol=1e-5)
    np.testing.assert_allclose(float(jb_r), float(jb_f), rtol=1e-6)
    gf, gr = to_np(gt), to_np(gr)
    rel = np.abs(gr - gf) / (np.abs(gf) + 1e-3)
    nrel = np.linalg.norm(gr - gf) / np.linalg.norm(gf)
    assert np.median(rel) < 1e-5 and nrel < 5e-4, (np.median(rel), nrel)


def test_window_predict_matches_jax(models):
    x0 = _bundle_np(1)[0]
    want = jcost._window_predict(jnp.asarray(x0), models["jflow"], LOW, WIN, models["params"])
    with torch.no_grad():
        got = tcost._window_predict(torch.from_numpy(x0), models["tflow"], LOW, WIN)
    assert got.shape == (WIN, 69, *FULL)
    # f32 through two flow steps; values that cross zero get a floor of
    # 1e-5 of the channel's std
    err = np.abs(to_np(got) - np.asarray(want))
    np.testing.assert_array_less(err, RTOL * np.abs(np.asarray(want))
                                 + RTOL * channels.STD.reshape(-1, 1, 1))


def test_step_checkpoint_is_value_neutral(models, reduced):
    tr = reduced[1]
    z = _z(1.0)
    out = {}
    for on in (True, False):
        c, _, _ = tcost.make_vae4dvar_cost_window_reduced(
            models["tdec"], models["tflow"], da_win=WIN, step_checkpoint=on)
        out[on] = _port_vg(c, z, tr)
    assert out[True][0] == out[False][0]
    g_on, g_off = to_np(out[True][1]), to_np(out[False][1])
    assert np.linalg.norm(g_on - g_off) / np.linalg.norm(g_off) < 1e-5


def test_window_cost_at_win1_is_3dvar_reduced(models):
    jb, tb = _bundles(da_win=1)
    wc, wts, _ = tcost.make_vae4dvar_cost_window_reduced(models["tdec"], da_win=1)
    c3, ts3, _ = tcost.make_vae4dvar_cost_reduced(models["tdec"])
    z = _z(1.0)
    vw, gw = _port_vg(wc, z, tcost.reduce_obs_window(tb, LOW))
    v3, g3 = _port_vg(c3, z, tcost.reduce_obs(tb, LOW))
    np.testing.assert_allclose(vw, v3, rtol=RTOL)
    np.testing.assert_allclose(to_np(gw), to_np(g3), rtol=RTOL,
                               atol=RTOL * np.abs(to_np(g3)).max())
