"""The 4D-Var window costs' counters and spans (utils/trace.py).

A micro relbias decoder and a micro relbias flow model on a 16x32 solver
grid under a 47x93 analysis grid, da_win 6 (five flow steps inside J), in
both forms of the window cost: the reduced one (with and without the step
checkpoint) and the full-grid one (always checkpointed). Checked:

- `window.rollout_steps` +5 an evaluation of J;
- `window.flow_forwards` +5 for a value alone or a jvp probe, +10 for a
  value and gradient under the step checkpoint (the backward recomputes
  each step), +5 without it;
- a solve's counters against its probes and diagnostics;
- with tracing on, `window.rollout` nests under `lbfgs.forward` and
  `lbfgs.jvp`, `window.step` under `window.rollout` or, for a
  checkpoint's recompute, under `lbfgs.backward` (the CPU runs the
  backward on the calling thread); with tracing off nothing is recorded;
- values and gradients bitwise equal with tracing on and off;
- a 3D-Var cost (da_win 1) moves no `window.*` counter.
"""

import numpy as np
import pytest
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch import config as C
from vaevar_tpu_torch.da import cost as tcost
from vaevar_tpu_torch.da.lbfgs import value_and_grad, value_and_slope
from vaevar_tpu_torch.da.solver import VariationalSolver
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.utils import trace

torch.set_num_threads(1)
LOW, FULL, WIN = (16, 32), (47, 93), 6
KEYS = ("window.rollout_steps", "window.flow_forwards")
# (form, step checkpoint): the reduced cost takes either, the full one
# always checkpoints its steps
FORMS = [("reduced", True), ("reduced", False), ("full", True)]


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable()
    trace.disable()
    yield
    trace.enable()
    trace.disable()


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    dec = LGUnet(C.micro_vae_configs(img_size=LOW)[1])
    flow = LGUnet(C.micro_config(img_size=LOW, attn_type="relbias"))
    for m in (dec, flow):
        m.eval().requires_grad_(False)
    return dec, flow


def _bundle(da_win=WIN, seed=0):
    rr = np.random.default_rng(seed)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    xb = (m + s * rr.normal(size=(69, *FULL))).astype(np.float32)
    yo = (m[None] + s[None] * rr.normal(size=(da_win, 69, *FULL))).astype(np.float32)
    H = (rr.random((da_win, 69, *FULL)) < 0.3).astype(np.float32)
    R = (s[None] ** 2 * (0.5 + rr.random((da_win, 69, 1, 1)))).astype(np.float32)
    return tcost.ObsBundle(*map(torch.from_numpy, (xb, yo, H, R)))


def _cost(models, form, step_checkpoint, da_win=WIN):
    """(cost, cost_parts, bundle) of the micro window cost in `form`."""
    dec, flow = models
    full = _bundle(da_win)
    if form == "reduced":
        cost, _, parts = tcost.make_vae4dvar_cost_window_reduced(
            dec, flow, da_win=da_win, step_checkpoint=step_checkpoint)
        return cost, parts, tcost.reduce_obs_window(full, LOW)
    cost, _, parts = tcost.make_vae4dvar_cost(dec, flow, flow_hw=LOW, da_win=da_win)
    return cost, parts, full


def _z(seed=3):
    return 0.3 * torch.randn((1, 8, *LOW), generator=torch.Generator().manual_seed(seed))


def _counted(fn):
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in KEYS}


@pytest.mark.parametrize("form, ckpt", FORMS)
def test_value_alone_counts_five_steps(models, form, ckpt):
    cost, parts, bundle = _cost(models, form, ckpt)
    z = _z()
    with torch.no_grad():
        _, got = _counted(lambda: cost(z, bundle))
        assert got == {"window.rollout_steps": 5, "window.flow_forwards": 5}
        _, got = _counted(lambda: parts(z, bundle))
    assert got == {"window.rollout_steps": 5, "window.flow_forwards": 5}


@pytest.mark.parametrize("form, ckpt", FORMS)
def test_value_and_grad_counts_the_recompute(models, form, ckpt):
    cost, _, bundle = _cost(models, form, ckpt)
    _, got = _counted(lambda: value_and_grad(lambda q: cost(q, bundle), _z()))
    assert got == {"window.rollout_steps": 5, "window.flow_forwards": 10 if ckpt else 5}


@pytest.mark.parametrize("form, ckpt", FORMS)
def test_jvp_probe_counts_five_steps(models, form, ckpt):
    cost, _, bundle = _cost(models, form, ckpt)
    z = _z()
    _, got = _counted(lambda: value_and_slope(lambda q: cost(q, bundle), z, torch.ones_like(z)))
    assert got == {"window.rollout_steps": 5, "window.flow_forwards": 5}


@pytest.mark.parametrize("linesearch", ["zoom", "jvp-zoom"])
def test_solve_counts_follow_its_probes(models, linesearch):
    """rollout_steps = 5 (probes + diagnostics, + the one uncharged jvp by
    which a first solve checks an explicit jvp-zoom); flow_forwards adds 5
    for each value and gradient (the checkpoint's recompute), none for a
    jvp."""
    cost, parts, bundle = _cost(models, "reduced", True)
    dec = models[0]
    to_state = tcost.make_vae4dvar_cost_window_reduced(dec, models[1], da_win=WIN)[1]
    solver = VariationalSolver(cost, to_state, parts, lbfgs_iters=3, linesearch=linesearch)
    gt = torch.stack([bundle.xb] * WIN)
    before = trace.counters()
    _, _, diag = solver.solve(torch.zeros((1, 8, *LOW)), bundle, nit=1, gt=gt, verbose=False)
    after = trace.counters()
    d = {k: after.get(k, 0) - before.get(k, 0)
         for k in KEYS + ("lbfgs.probes", "lbfgs.jvp")}
    n_diag = len(diag.loss_obs)
    assert n_diag == 2 and d["lbfgs.jvp"] == sum(diag.n_jvp)
    check = linesearch == "jvp-zoom"
    assert d["window.rollout_steps"] == 5 * (d["lbfgs.probes"] + n_diag + check)
    reverse = d["lbfgs.probes"] - d["lbfgs.jvp"]
    assert d["window.flow_forwards"] == d["window.rollout_steps"] + 5 * reverse


def _spans(models, form, ckpt):
    cost, _, bundle = _cost(models, form, ckpt)
    z = _z()

    def fun(q):
        return cost(q, bundle)

    value_and_grad(fun, z)
    value_and_slope(fun, z, torch.ones_like(z))


@pytest.mark.parametrize("form, ckpt", FORMS)
def test_spans_nest_under_the_probes(models, form, ckpt):
    trace.enable()
    _spans(models, form, ckpt)
    trace.disable()
    recs = trace.records()
    by_id = {r["id"]: r for r in recs}

    def parent(r):
        return by_id[r["parent"]]["name"] if r["parent"] is not None else None

    rollouts = [parent(r) for r in recs if r["name"] == "window.rollout"]
    assert rollouts == ["lbfgs.forward", "lbfgs.jvp"]
    steps = [parent(r) for r in recs if r["name"] == "window.step"]
    assert steps.count("window.rollout") == 10
    assert steps.count("lbfgs.backward") == (5 if ckpt else 0)
    assert len(steps) == (15 if ckpt else 10)
    assert all(r["device_ms"] is None for r in recs)  # no card: no device time


@pytest.mark.parametrize("form, ckpt", FORMS)
def test_tracing_off_records_nothing(models, form, ckpt):
    _spans(models, form, ckpt)
    assert trace.records() == []


@pytest.mark.parametrize("form, ckpt", FORMS)
def test_tracing_changes_no_value_or_gradient(models, form, ckpt):
    cost, _, bundle = _cost(models, form, ckpt)
    z = _z()

    def probes():
        def fun(q):
            return cost(q, bundle)

        v, g = value_and_grad(fun, z)
        jv, js = value_and_slope(fun, z, torch.ones_like(z))
        return v, g, jv, js

    off = probes()
    trace.enable()
    on = probes()
    trace.disable()
    assert off[0] == on[0]
    for a, b in zip(off[1:], on[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["reduced", "full", "3dvar"])
def test_3dvar_cost_moves_no_window_counter(models, form):
    dec, flow = models
    full = _bundle(1)
    if form == "3dvar":
        cost = tcost.make_vae4dvar_cost_reduced(dec)[0]
        bundle = tcost.reduce_obs(full, LOW)
    else:
        cost, _, bundle = _cost(models, form, True, da_win=1)
    trace.enable()
    _, got = _counted(lambda: value_and_grad(lambda q: cost(q, bundle), _z()))
    trace.disable()
    assert got == {k: 0 for k in KEYS}
    assert not [r for r in trace.records() if r["name"].startswith("window.")]
