"""The port's vae4dvar 3D-Var cost and L-BFGS against the JAX package.

Cost: reduce_obs, J(z) and dJ/dz on the micro VAE decoder latent with
bridged weights, rtol 1e-5 (f32 sums over ~10^5 terms in another order).

L-BFGS: the random SPD quadratics of tests/test_lbfgs_torch_trajectory.py,
4 segments x 10 iterations on one carried state. Both run optax's
algorithm, so the per-segment iteration and closure-eval counts are equal
and the iterates agree to f32 round-off after segment 1 (rel 1e-4; observed
~1e-6). Later segments amplify that round-off (condition number 1e4): the
final objectives agree within rel 2e-3 (observed <= 6.6e-4), while the JAX
solver against itself, with the same f32 arithmetic summed in another order
(x@A@x against sum(x*(A@x))), moves its final objective by up to 1.4e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import model_pair, quadratic, rand, to_np
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da import cost as jcost
from vaevar_tpu.da import lbfgs as jlbfgs
from vaevar_tpu.da.obs import build_R, make_obs_mask, obs_error_variance
from vaevar_tpu_torch.da import cost as tcost
from vaevar_tpu_torch.da import lbfgs as tlbfgs
from vaevar_tpu_torch.da.solver import VariationalSolver

torch.set_num_threads(1)
RTOL = 1e-5


def _obs(hw=(64, 128), seed=0):
    rng = np.random.default_rng(seed)
    gt = (channels.MEAN.reshape(-1, 1, 1)
          + channels.STD.reshape(-1, 1, 1) * rng.standard_normal((69, *hw))).astype(np.float32)
    xb = (gt + 0.1 * channels.STD.reshape(-1, 1, 1)
          * rng.standard_normal((69, *hw))).astype(np.float32)
    H = make_obs_mask("free_0001", 1, hw, rng)
    R = build_R(obs_error_variance(0.005, 2), None, 1, hw)
    return xb, gt[None], H, R


@pytest.fixture(scope="module")
def setup():
    cfg = C.micro_vae_configs(img_size=(32, 64))[1]
    jm, params, tm = model_pair(cfg)
    xb, yo, H, R = _obs()
    jb = jcost.reduce_obs(jcost.ObsBundle(*(jnp.asarray(a) for a in (xb, yo, H, R))), (32, 64))
    tb = tcost.reduce_obs(tcost.ObsBundle(*(torch.from_numpy(a) for a in (xb, yo, H, R))), (32, 64))
    tm.requires_grad_(False)
    return dict(jm=jm, params=params, tm=tm, jb=jb, tb=tb)


def test_reduce_obs(setup):
    jb, tb = setup["jb"], setup["tb"]
    for name in ("a", "b", "c"):
        np.testing.assert_allclose(to_np(getattr(tb, name)), np.asarray(getattr(jb, name)),
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("zscale", [0.0, 1.0])
def test_cost_and_gradient(setup, zscale):
    jcost_fn, _, jparts = jcost.make_vae4dvar_cost_reduced(setup["jm"].apply)
    tcost_fn, _, tparts = tcost.make_vae4dvar_cost_reduced(setup["tm"])
    z = rand((1, 8, 32, 64), 11, zscale)
    p = {"decoder": setup["params"]}
    vj, gj = jax.jit(jax.value_and_grad(lambda q: jcost_fn(q, setup["jb"], p)))(jnp.asarray(z))
    vt, gt = tlbfgs.value_and_grad(lambda q: tcost_fn(q, setup["tb"]), torch.from_numpy(z))
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(gj)).max())
    for a, b in zip(tparts(torch.from_numpy(z), setup["tb"]),
                    jparts(jnp.asarray(z), setup["jb"], p)):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_lbfgs_matches_jax_segments(seed):
    A, b = quadratic(seed)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.from_numpy(A), torch.from_numpy(b)
    xj, sj = jnp.zeros(64, jnp.float32), None
    xt, st = torch.zeros(64), None
    sj = jlbfgs.lbfgs_init_state(xj, history=10)
    for seg in range(4):
        rj = jlbfgs.lbfgs_minimize(lambda x: 0.5 * x @ Aj @ x - bj @ x, xj,
                                   max_iters=10, history=10, init_state=sj)
        rt = tlbfgs.lbfgs_minimize(lambda x: 0.5 * x @ At @ x - bt @ x, xt,
                                   max_iters=10, history=10, init_state=st)
        xj, sj, xt, st = rj.x, rj.state, rt.x, rt.state
        assert (rt.n_iters, rt.n_evals) == (int(rj.n_iters), int(rj.n_evals)), seg
        if seg == 0:
            rel = np.linalg.norm(xt.numpy() - np.asarray(xj)) / np.linalg.norm(np.asarray(xj))
            assert rel < 1e-4, rel
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    f = [0.5 * x @ A64 @ x - b64 @ x for x in (np.asarray(xj, np.float64),
                                              xt.numpy().astype(np.float64))]
    assert abs(f[1] - f[0]) <= 2e-3 * abs(f[0]), f


def test_solver_refuses_other_linesearches():
    """auto, zoom and jvp-zoom are the linesearches; any other name fails
    when the solver or a minimisation is set up."""
    parts = (lambda x, b: x.sum(), lambda x, b: x, lambda x, b: (0.0, 0.0))
    for ls in ("auto", "zoom", "jvp-zoom"):
        assert VariationalSolver(*parts, linesearch=ls).linesearch == ls
    with pytest.raises(ValueError, match="backtracking"):
        VariationalSolver(*parts, linesearch="backtracking")
    with pytest.raises(ValueError, match="backtracking"):
        tlbfgs.lbfgs_minimize(lambda x: (x * x).sum(), torch.ones(3), linesearch="backtracking")
