"""The 4D-Var window solve's CUDA graphs (vaevar_tpu_torch/da/graphs.py on
cost.make_vae4dvar_cost_window_reduced: the decoder and the flow model's
steps inside J); tests/test_torch_solve_graph.py holds the rule and the
3D-Var cost's.

On the CPU:
- utils/capture.py::checkpoint is torch's non-reentrant checkpoint as
  before eagerly, and keeps no RNG state under a capture;
- a micro window solve (da_win 6, five flow steps) through the stand-in
  capture of tests/test_torch_solve_graph.py, whose replay recomputes the
  captured body eagerly into the graphs' buffers and counts nothing: the
  eager solve's numbers bit for bit, and its counters
  (`window.rollout_steps`, `window.flow_forwards`), with and without the
  step checkpoint, under zoom and jvp-zoom; one capture for three solves;
  with tracing on, one `window.step` record per flow step the eager solve
  spans, each replayed one with the device time of its events.

On the card (`-m gpu`; `python -m pytest --noconftest -m gpu
tests/test_torch_window_graph.py`), VAE_DECODER and FLOW_140 in bf16 with
block remat at the 128x256 solver grid, random weights, five flow steps
under the step checkpoint (run_da --da_win 6 --win_remat both), seeded obs
at 721x1440: the replayed value and gradient and their counters against
the eager ones and the replayed `window.step` device times; the decode
graph against to_state and cost_parts; three solves with one capture
against the eager solver; a capture while a worker thread runs CUDA work on
its own stream; `lgunet.cast_held` per replay the eager probe's; after an
in-place reload of both models' weights the replay bitwise the eager value
and gradient at the new weights, with no new capture.
"""

import threading
from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_solve_graph import (
    _agree,
    _micro_decoder,
    _micro_flow,
    _n_held,
    _same_diag,
    _scaled,
    stand_in_capture,
    window_bundle,
)
from vaevar_tpu_torch import channels
from vaevar_tpu_torch import config as cfgs
from vaevar_tpu_torch.da import cost as cost_mod
from vaevar_tpu_torch.da import lbfgs
from vaevar_tpu_torch.da.graphs import SolveGraphs
from vaevar_tpu_torch.da.solver import VariationalSolver
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.ops import interp
from vaevar_tpu_torch.utils import capture, trace

torch.set_num_threads(1)
WIN = 6
KEYS = ("window.rollout_steps", "window.flow_forwards", "solve.graph_captures",
        "lbfgs.graph_replays", "lbfgs.probes", "lbfgs.jvp", "lgunet.cast_held",
        "lgunet.cast_made")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable()
    trace.disable()
    yield
    trace.enable()
    trace.disable()


def _added(before):
    after = trace.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in KEYS}


# --- the checkpoint ----------------------------------------------------------


@pytest.mark.parametrize("capturing", [False, True])
def test_checkpoint_keeps_no_rng_state_only_under_capture(monkeypatch, capturing):
    calls = []
    real = capture._torch_checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(capture._torch_checkpoint, "checkpoint", spy)
    monkeypatch.setattr(capture, "capturing", lambda: capturing)
    x = torch.randn(5, requires_grad=True)
    y = capture.checkpoint(torch.sin, x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(y, torch.sin(x)) and torch.equal(g, torch.cos(x))
    assert calls == [dict(use_reentrant=False, preserve_rng_state=False) if capturing
                     else dict(use_reentrant=False)]


# --- the window solve with a stand-in replay on the CPU ---------------------


class _Event:
    """An external timing event on the CPU: each reads 1.5 ms."""

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5


def _micro_window(step_checkpoint, seeds):
    decoder, c = _micro_decoder()
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_window_reduced(
        decoder, _micro_flow(), da_win=WIN, step_checkpoint=step_checkpoint)
    bundles = [window_bundle((47, 93), (16, 32), WIN, seed) for seed in seeds]
    return cost, to_state, parts, bundles, torch.zeros((1, c, 16, 32))


def _traced_solves(solver, x0, bundles):
    before = trace.counters()
    trace.enable()
    out = [solver.solve(x0, b, nit=1, gt=gt, verbose=False) for b, gt in bundles]
    recs = trace.records()
    trace.disable()
    return out, _added(before), recs


@pytest.mark.parametrize("step_checkpoint", [True, False])
@pytest.mark.parametrize("linesearch", ["zoom", "jvp-zoom"])
def test_stand_in_window_solves_bitwise_as_eager(monkeypatch, step_checkpoint, linesearch):
    monkeypatch.setattr(SolveGraphs, "_capture", stand_in_capture)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    cost, to_state, parts, bundles, x0 = _micro_window(step_checkpoint, (31, 32, 33))
    kw = dict(lbfgs_iters=2, history=2, linesearch=linesearch)
    eager, de, re = _traced_solves(VariationalSolver(cost, to_state, parts, **kw), x0, bundles)
    graphed, dg, rg = _traced_solves(VariationalSolver(
        cost, to_state, parts, evaluations=SolveGraphs(cost, to_state, parts), **kw), x0, bundles)
    for (ze, xe, diag_e), (zg, xg, diag_g) in zip(eager, graphed):
        assert torch.equal(ze, zg) and torch.equal(xe, xg)
        _same_diag(diag_e, diag_g)
    # the graphed solve counts what the eager one counts, plus its capture
    # and replays: every value and gradient is a replay, a jvp probe eager
    for k in ("window.rollout_steps", "window.flow_forwards", "lbfgs.probes", "lbfgs.jvp"):
        assert dg[k] == de[k], k
    assert dg["solve.graph_captures"] == 1
    assert dg["lbfgs.graph_replays"] == dg["lbfgs.probes"] - dg["lbfgs.jvp"] > 0
    # one window.step record a flow step, a replayed one with its events' time
    steps_e = [r for r in re if r["name"] == "window.step"]
    steps_g = [r for r in rg if r["name"] == "window.step"]
    assert len(steps_e) == len(steps_g) == de["window.flow_forwards"]
    replayed = [r for r in steps_g if r["device_ms"] is not None]
    by_id = {r["id"]: r["name"] for r in rg}
    assert {r["device_ms"] for r in replayed} == {1.5}
    assert Counter(by_id[r["parent"]] for r in replayed) == {
        "lbfgs.probe": (10 if step_checkpoint else 5) * dg["lbfgs.graph_replays"],
        "solve.diagnostics": 5 * 2 * len(bundles)}
    # a jvp probe stays eager: its steps span under its rollout, no device time
    assert len(steps_g) - len(replayed) == 5 * (dg["lbfgs.jvp"] + (linesearch == "jvp-zoom"))
    assert not [r for r in rg if r["name"] in ("lbfgs.forward", "lbfgs.backward")]


# --- on the card --------------------------------------------------------------


def _card_bundles(seeds, full_hw=(721, 1440), low_hw=(128, 256)):
    """(ReducedWindowObs, truth of slot 0) of seeded synthetic window obs
    made on the card: 10 % of the columns observed in each slot with the
    README's obs errors, the truth the background plus a smooth
    perturbation per slot."""
    from vaevar_tpu_torch.da import obs as obs_mod

    var = torch.as_tensor(obs_mod.obs_error_variance(0.005, 2), dtype=torch.float32,
                          device="cuda").reshape(1, -1, 1, 1)
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device="cuda")[:, None, None]
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device="cuda")[:, None, None]
    out = []
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        xb = mean + std * torch.randn((69, *full_hw), generator=g, device="cuda")
        bump = torch.randn((WIN, 69, *low_hw), generator=g, device="cuda")
        gt = xb[None] + 0.02 * std * interp.resize_nearest(bump, full_hw)
        H = (torch.rand((WIN, 1, *full_hw), generator=g, device="cuda") < 0.1).float()
        H = H.expand(-1, 69, -1, -1)
        bundle = cost_mod.reduce_obs_window(
            cost_mod.ObsBundle(xb=xb, yo=H * gt, H=H, R=var), low_hw)
        out.append((bundle, gt[:1].clone()))
        del gt, H
    return out


@pytest.fixture(scope="module")
def card_models():
    """VAE_DECODER and FLOW_140 (bf16 compute, block remat, f32 weights from
    torch's default initialisation) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # as run_da
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    return [LGUnet(cfg.replace(dtype=torch.bfloat16, remat=True)).to("cuda").eval()
            .requires_grad_(False) for cfg in (cfgs.VAE_DECODER, cfgs.FLOW_140)]


@pytest.fixture(scope="module")
def card(card_models):
    """The models' reduced window cost with the step checkpoint on the card,
    with seeded window obs at 721x1440 reduced onto the 128x256 solver
    grid."""
    models = card_models
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_window_reduced(
        *models, da_win=WIN, step_checkpoint=True)
    bundles = _card_bundles((41, 42, 43))
    x0 = torch.zeros((1, sum(cfgs.VAE_DECODER.inchans_list), 128, 256), device="cuda")
    return cost, to_state, parts, bundles, x0


def _z(shape, seed):
    return 0.3 * torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                             device="cuda")


@pytest.mark.gpu
def test_card_replayed_value_and_gradient(card):
    cost, to_state, parts, bundles, x0 = card
    bundle, _ = bundles[0]
    graphs = SolveGraphs(cost, to_state, parts)
    graphs.load(x0, bundle)
    for seed in (4, 5):
        z = _z(x0.shape, seed)
        before = trace.counters()
        trace.enable()
        v, grad = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
        eager = trace.records()
        added_e = _added(before)
        before = trace.counters()
        trace.enable()
        vg, gradg = graphs.value_and_grad(z)
        replayed = trace.records()
        trace.disable()
        added_g = _added(before)
        print(f"value eager {v!r}, replayed {vg!r}; lgunet.cast_held eager "
              f"{added_e['lgunet.cast_held']}, replayed {added_g['lgunet.cast_held']}")
        assert abs(vg - v) <= 1e-6 * abs(v)
        _agree(gradg, grad, "gradient")
        for k in ("window.rollout_steps", "window.flow_forwards", "lgunet.cast_held"):
            assert added_g[k] == added_e[k], k
        assert added_g["lgunet.cast_held"] > 0 and added_g["lgunet.cast_made"] == 0
        assert added_e["window.flow_forwards"] == 10 and added_g["lbfgs.graph_replays"] == 1
        ms_e = [r["device_ms"] for r in eager if r["name"] == "window.step"]
        ms_g = [r["device_ms"] for r in replayed if r["name"] == "window.step"]
        print(f"window.step device ms: eager {sum(ms_e):.2f} over {len(ms_e)}, "
              f"replayed {sum(ms_g):.2f} over {len(ms_g)}")
        assert len(ms_g) == len(ms_e) == 10 and all(ms > 0 for ms in ms_g)


@pytest.mark.gpu
def test_card_decode_graph_is_to_state_and_cost_parts(card):
    cost, to_state, parts, bundles, x0 = card
    bundle, _ = bundles[1]
    graphs = SolveGraphs(cost, to_state, parts)
    graphs.load(x0, bundle)
    z = _z(x0.shape, 6)
    with torch.no_grad():
        want, (jb, jo) = to_state(z, bundle), parts(z, bundle)
    before = trace.counters()
    state, jbg, jog = graphs.decode(z)
    added = _added(before)
    _agree(state, want, "decoded state")
    print(f"Jo eager {float(jo)!r}, replayed {float(jog)!r}")
    assert float(jbg) == float(jb)
    assert abs(float(jog) - float(jo)) <= 1e-5 * abs(float(jo))
    assert added["window.rollout_steps"] == added["window.flow_forwards"] == 5


@pytest.mark.gpu
def test_card_three_solves_one_capture(card):
    cost, to_state, parts, bundles, x0 = card
    kw = dict(lbfgs_iters=4, history=4, linesearch="zoom")
    eager = [VariationalSolver(cost, to_state, parts, **kw).solve(
        x0, b, nit=1, gt=gt, verbose=False) for b, gt in bundles]
    before = trace.counters()
    solver = VariationalSolver(cost, to_state, parts, evaluations=SolveGraphs(cost, to_state, parts),
                               **kw)
    graphed = [solver.solve(x0, b, nit=1, gt=gt, verbose=False) for b, gt in bundles]
    added = _added(before)
    assert added["solve.graph_captures"] == 1
    assert added["lbfgs.graph_replays"] == added["lbfgs.probes"]
    # the probes' and diagnostics' steps, the checkpoint's recompute, and
    # the capture's two warm-up runs of each body (eager runs, counted)
    n_diag = 2 * len(bundles)
    assert added["window.rollout_steps"] == 5 * (added["lbfgs.probes"] + n_diag + 4)
    assert added["window.flow_forwards"] == (added["window.rollout_steps"]
                                             + 5 * (added["lbfgs.probes"] + 2))
    for (_, _, de), (_, _, dg) in zip(eager, graphed):
        print(f"evals {de.n_evals} / {dg.n_evals}; Jb {de.loss_reg[-1]!r} / "
              f"{dg.loss_reg[-1]!r}; Jo {de.loss_obs[-1]!r} / {dg.loss_obs[-1]!r}")
        assert de.n_evals == dg.n_evals
        for a, b in zip(de.loss_reg + de.loss_obs, dg.loss_reg + dg.loss_obs):
            assert abs(a - b) <= 1e-5 * abs(a), (a, b)
        assert dg.loss_obs[-1] < dg.loss_obs[0]


@pytest.mark.gpu
def test_card_capture_beside_a_worker_stream(card):
    """The obs prefetch's pattern on another thread during the warm-up and
    the capture: pageable host-to-device copies, kernels and event waits on
    a stream of its own."""
    cost, to_state, parts, bundles, x0 = card
    bundle, _ = bundles[2]
    stream = torch.cuda.Stream()
    started, stop, done, errors = threading.Event(), threading.Event(), [], []

    def worker():
        try:
            host = np.random.default_rng(0).random((69, 721, 1440), dtype=np.float32)
            with torch.cuda.stream(stream):
                while not stop.is_set():
                    t = torch.as_tensor(host, device="cuda")
                    s = (t * 2.0).sum()
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    ev.synchronize()
                    done.append(float(s))
                    started.set()
        except Exception as e:  # the test reads it
            errors.append(e)
            started.set()

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        assert started.wait(60)
        graphs = SolveGraphs(cost, to_state, parts)
        n_before = len(done)
        graphs.load(x0, bundle)
        n_during = len(done) - n_before
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and not errors, errors
    print(f"worker iterations during the warm-up and capture: {n_during}")
    assert n_during >= 1
    z = _z(x0.shape, 7)
    v, grad = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
    vg, gradg = graphs.value_and_grad(z)
    assert abs(vg - v) <= 1e-6 * abs(v)
    _agree(gradg, grad, "gradient after a capture beside a worker")


@pytest.mark.gpu
def test_card_weights_reloaded_in_place(card, card_models):
    """An in-place reload of the decoder's and FLOW_140's weights between
    solves: `load` remakes their held copies where the graphs read them,
    with no new capture, and the replay gives the eager value and gradient
    at the new weights bitwise."""
    cost, to_state, parts, bundles, x0 = card
    bundle, _ = bundles[0]
    z = _z(x0.shape, 8)
    graphs = SolveGraphs(cost, to_state, parts, models=card_models)
    graphs.load(x0, bundle)
    v0, _ = graphs.value_and_grad(z)
    originals = [{k: t.clone() for k, t in m.state_dict().items()} for m in card_models]
    try:
        for m, original in zip(card_models, originals):
            m.load_state_dict(_scaled(original, 1.01))
        before = trace.counters()
        graphs.load(x0, bundle)
        added = _added(before)
        n = sum(_n_held(m) for m in card_models)
        print(f"reload: {added['lgunet.cast_made']} copies remade of {n}, "
              f"{added['solve.graph_captures']} captures")
        assert added["solve.graph_captures"] == 0 and added["lgunet.cast_made"] == n > 0
        v, grad = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
        vg, gradg = graphs.value_and_grad(z)
        print(f"value before the reload {v0!r}; eager {v!r}, replayed {vg!r}")
        assert vg == v != v0
        assert torch.equal(gradg, grad)
    finally:
        for m, original in zip(card_models, originals):
            m.load_state_dict(original)
