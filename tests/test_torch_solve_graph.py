"""The solve's CUDA graphs (vaevar_tpu_torch/da/graphs.py) on the 3D-Var
cost, and the rule that picks them (da/graphs.py::solve_evaluations, as the
cycler's solver construction calls it); tests/test_torch_window_graph.py
holds the 4D-Var window's.

On the CPU:
- the rule: on a CUDA device it picks SolveGraphs for the reduced vae4dvar
  costs alone, 3D-Var and the window with its flow model; a mesh, a
  tensor-parallel decoder or flow model, sc4dvar (3D-Var and window), the
  full-grid (real obs) cost and a window without a flow model keep the
  eager Evaluations. Micro cycles of each on the CPU build no graphs, count
  no capture and no replay, and hand L-BFGS the solver's eager
  Evaluations;
- the tables the captured region needs on the device, made once
  (utils/capture.py::device_tables): the increment's scales
  (cost._increment_fn), the nearest resize's indices (ops/interp.py), the
  normalisation of dynamics.make_integrate and the window's gathers,
  bitwise the per-call tables they replace; one first made inside a
  capture raises;
- the graphed solve's control flow with a stand-in for the capture whose
  replay recomputes the captured body eagerly into the graphs' buffers:
  three solves on three bundles give the eager solver's numbers bit for
  bit, with one capture, one replay per probe and an `lbfgs.replay` span in
  each probe; a new shape captures again; `load` remakes a reloaded
  decoder's held weight copies (models/lgunet.py::held) in place without
  capturing again, and captures again where one cannot be.

On the card (`-m gpu`; `python -m pytest --noconftest -m gpu
tests/test_torch_solve_graph.py`), the production VAE_DECODER in bf16 at
its 128x256 latent with random weights: the replayed value and gradient
against the eager ones, three solves against the eager solver, the decode
graph's state against to_state, and a capture while a worker thread runs
CUDA work on its own stream; `lgunet.cast_held` per replay the eager
probe's; after an in-place weight reload the replay bitwise the eager
value and gradient at the new weights, with no new capture; a held copy
first asked for inside a real capture raises.
"""

import contextlib
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_held_casts import _n_held
from vaevar_tpu_torch import channels
from vaevar_tpu_torch import config as cfgs
from vaevar_tpu_torch.da import cost as cost_mod
from vaevar_tpu_torch.da import graphs as graphs_mod
from vaevar_tpu_torch.da import lbfgs
from vaevar_tpu_torch.da import solver as solver_mod
from vaevar_tpu_torch.da.graphs import Evaluations, SolveGraphs
from vaevar_tpu_torch.da.solver import VariationalSolver
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.ops import interp
from vaevar_tpu_torch.parallel.mesh import Tile
from vaevar_tpu_torch.utils import capture, trace

torch.set_num_threads(1)
ONE_CYCLE = ["--device", "cpu", "--micro", "--fast_init", "--Nit", "2", "--end_time",
             "2022-01-01 06:00:00"]
MICRO = ONE_CYCLE + ["--grid", "32x64", "--solver_grid", "32x64"]
# (name, run_da flags): every solving path the cycler builds on the CPU
PATHS = {
    "vae4dvar_3dvar": MICRO,
    "sc4dvar": ONE_CYCLE + ["--da_mode", "sc4dvar", "--grid", "64x128", "--solver_grid",
                            "32x64"],
    "window": MICRO + ["--da_win", "2", "--no-bf16"],
    "sc4dvar_window": ONE_CYCLE + ["--da_mode", "sc4dvar", "--grid", "32x64",
                                   "--solver_grid", "32x64", "--da_win", "2"],
    "real_obs": MICRO + ["--obs_type", "real_simu", "--use_eval"],
}
GRAPHED = ("vae4dvar_3dvar", "window")  # the paths the rule takes on a CUDA device
GRAPH_COUNTERS = ("solve.graph_captures", "lbfgs.graph_replays")


def _counts():
    c = trace.counters()
    return {k: c.get(k, 0) for k in GRAPH_COUNTERS}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable()
    trace.disable()
    yield
    trace.enable()
    trace.disable()


# --- the rule, on micro cycles ---------------------------------------------


@pytest.fixture(scope="module", params=sorted(PATHS))
def micro_cycle(request, tmp_path_factory):
    """One micro cycle of a path on the CPU: (name, CycledDA, the graph
    counters it added, the evaluations each segment got)."""
    from vaevar_tpu_torch import run_da

    name = request.param
    got = []
    minimize = solver_mod.lbfgs_minimize

    def spy(*a, **kw):
        got.append(kw["evaluations"])
        return minimize(*a, **kw)

    solver_mod.lbfgs_minimize = spy
    before = _counts()
    try:
        da = run_da.main(PATHS[name] + ["--work_dir", str(tmp_path_factory.mktemp(name))])
    finally:
        solver_mod.lbfgs_minimize = minimize
    after = _counts()
    return name, da, {k: after[k] - before[k] for k in GRAPH_COUNTERS}, got


def test_cpu_cycle_builds_no_graph_and_solves_eagerly(micro_cycle):
    name, da, added, got = micro_cycle
    assert type(da._solver.evaluations) is Evaluations
    assert not hasattr(da._solver.evaluations, "bundle")  # let go after the solve
    assert added == {k: 0 for k in GRAPH_COUNTERS}
    assert len(da.cycle_log) == 1 and len(got) == da.cfg.nit
    assert all(e is da._solver.evaluations for e in got), name


def _placed(model):
    """`model` with a tensor-parallel branch: it sums over its tp group."""
    from vaevar_tpu_torch.parallel.tensor_parallel import _RowParallel

    blk = model.net.layers[0].blocks[0]
    return torch.nn.Sequential(model, _RowParallel(blk.mlp, "hidden", "fc2", None,
                                                   blk.mlp.fc1.out_features, 1))


def _graphed(da):
    """Whether the solver the cycler builds for `da` as it stands holds the
    CUDA graphs (da/graphs.py::solve_evaluations picks them)."""
    evals = da._build_solver().evaluations
    assert type(evals) in (Evaluations, SolveGraphs)
    return type(evals) is SolveGraphs


def test_rule_on_a_cuda_device(micro_cycle):
    """Read on a CPU-built cycler with its device name changed: the rule
    reads only the configuration, the obs form, the mesh, the models'
    placement and the device type."""
    name, da, _, _ = micro_cycle
    device, decoder, flow, interp_matrix = da.device, da.decoder, da.flow, da._interp
    reduce_obs = da._reduce_obs
    try:
        da.device = "cuda"
        assert _graphed(da) == (name in GRAPHED)
        da.mesh = object()
        assert not _graphed(da)
        da.mesh = None
        for role in ("decoder", "flow"):
            model = getattr(da, role)
            if model is not None:
                setattr(da, role, _placed(model))
                assert not _graphed(da), role
                setattr(da, role, model)
        if name == "window":  # the full-grid window: real obs, or no flow model
            da._interp = np.eye(13, dtype=np.float32)
            assert not _graphed(da)
            da._interp, da.flow = interp_matrix, None
            assert not _graphed(da)
    finally:
        da.device, da.mesh, da.decoder, da.flow, da._interp = (device, None, decoder, flow,
                                                               interp_matrix)
        da._reduce_obs = reduce_obs


# --- the device tables, made once --------------------------------------------


class _NoCopy:
    def __init__(self, real):
        self.real = real

    def __call__(self, data, *a, **kw):
        if isinstance(data, np.ndarray):
            raise AssertionError("a table crossed from the host")
        return self.real(data, *a, **kw)


def _increment_per_call(decoder, z):
    """cost._increment_fn's arithmetic with its tables made at every call."""
    err = torch.as_tensor(channels.ERR_STD, dtype=torch.float32, device=z.device)
    mstd = torch.as_tensor(channels.STD, dtype=torch.float32, device=z.device)
    return decoder(z)[0].float() * err.reshape(-1, 1, 1) * mstd.reshape(-1, 1, 1)


def _micro_decoder(hw=(16, 32), dtype=None):
    torch.manual_seed(0)
    cfg = cfgs.micro_vae_configs(img_size=hw)[1].replace(dtype=dtype)
    return LGUnet(cfg).eval().requires_grad_(False), sum(cfg.inchans_list)


def _resize_per_call(x, out_hw, tile=None):
    """ops/interp.py::resize_nearest with its index tables made at every call."""
    H, W = x.shape[-2], x.shape[-1]
    hi, wi = interp._nearest_idx(out_hw[0], H), interp._nearest_idx(out_hw[1], W)
    if tile is not None:
        hi, wi = hi[tile.rows], wi[tile.cols]
    return (x.index_select(-2, torch.as_tensor(hi, device=x.device))
            .index_select(-1, torch.as_tensor(wi, device=x.device)))


def _micro_flow(hw=(16, 32)):
    torch.manual_seed(1)
    return LGUnet(cfgs.micro_config(img_size=hw, attn_type="relbias")).eval().requires_grad_(
        False)


def _integrate_per_call(model, model_hw, x, steps, interpolation):
    """dynamics.make_integrate's arithmetic with its tables made at every
    call (no grad: the steps need no checkpoint)."""
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=x.device).reshape(-1, 1, 1)
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=x.device).reshape(-1, 1, 1)
    hw = tuple(x.shape[-2:])
    z = ((x - mean) / std)[None]
    resize = interpolation and model_hw is not None and hw != tuple(model_hw)
    if resize:
        z = interp.resize_nearest(z, model_hw)
    for _ in range(steps):
        z = model(z)[:, :channels.N_CHANNELS]
    if resize:
        z = interp.resize_nearest(z, hw)
    return z[0] * std + mean


def _increment_user(dtype):
    """cost._increment_fn's scales."""
    decoder, c = _micro_decoder(dtype=dtype)
    zs = [torch.randn((1, c, 16, 32), generator=torch.Generator().manual_seed(seed))
          for seed in (1, 2)]
    return (zs, lambda z: _increment_per_call(decoder, z), cost_mod._increment_fn(decoder))


def _resize_user(in_hw, out_hw, tile):
    """ops/interp.py::resize_nearest's indices."""
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn((3, *in_hw), generator=g) for _ in range(2)]
    return (xs, lambda x: _resize_per_call(x, out_hw, tile),
            lambda x: interp.resize_nearest(x, out_hw, tile))


def _integrate_user(x_hw, model_hw, steps, interpolation):
    """dynamics.make_integrate's normalisation, no grad."""
    from vaevar_tpu_torch.da.dynamics import make_integrate

    flow = _micro_flow()
    integrate = make_integrate(flow, model_hw)
    mean = torch.as_tensor(channels.MEAN)[:, None, None]
    std = torch.as_tensor(channels.STD)[:, None, None]
    g = torch.Generator().manual_seed(7)
    xs = [mean + std * torch.randn((69, *x_hw), generator=g) for _ in range(2)]
    return (xs,
            torch.no_grad()(lambda x: _integrate_per_call(flow, model_hw, x, steps,
                                                          interpolation)),
            torch.no_grad()(lambda x: integrate(x, steps, interpolation)))


def _window_user(full_hw):
    """The window cost's gathers: its value and gradient with every table
    made at an earlier call against a fresh cost's, which makes them at
    this call as every call made them before."""
    decoder, c = _micro_decoder()
    flow = _micro_flow()

    def fresh():
        return cost_mod.make_vae4dvar_cost_window_reduced(decoder, flow, da_win=3)[0]

    cost = fresh()
    bundle, _ = window_bundle(full_hw, (16, 32), 3, seed=4)
    g = torch.Generator().manual_seed(8)
    zs = [0.3 * torch.randn((1, c, 16, 32), generator=g) for _ in range(2)]
    return (zs, lambda z: lbfgs.value_and_grad(lambda q: fresh()(q, bundle), z),
            lambda z: lbfgs.value_and_grad(lambda q: cost(q, bundle), z))


# (id, user, its arguments): every user of utils/capture.py::device_tables
TABLE_USERS = [
    ("increment-f32", _increment_user, (None,)),
    ("increment-bf16", _increment_user, (torch.bfloat16,)),
    # up, a non-integer ratio (721x1440 over 128x256); down; a mesh tile
    ("resize-up", _resize_user, ((16, 32), (73, 144), None)),
    ("resize-down", _resize_user, ((32, 64), (16, 32), None)),
    ("resize-tile", _resize_user, ((16, 32), (72, 144), Tile(slice(36, 72), slice(0, 72), True))),
    # the window's flow step, a spin-up, the advance through a resize
    ("integrate-step", _integrate_user, ((16, 32), None, 1, False)),
    ("integrate-spin-up", _integrate_user, ((16, 32), None, 2, False)),
    ("integrate-resize", _integrate_user, ((32, 64), (16, 32), 1, True)),
    # S the identity (the solver grid), an integer ratio, 47x93 over 16x32
    ("window-identity", _window_user, ((16, 32),)),
    ("window-ratio", _window_user, ((32, 64),)),
    ("window-47x93", _window_user, ((47, 93),)),
]


def _equal(got, want):
    if isinstance(want, tuple):
        return all(_equal(a, b) for a, b in zip(got, want, strict=True))
    return torch.equal(got, want) if isinstance(want, torch.Tensor) else got == want


@pytest.mark.parametrize("user, args", [u[1:] for u in TABLE_USERS],
                         ids=[u[0] for u in TABLE_USERS])
def test_device_tables_bitwise_and_made_once(monkeypatch, user, args):
    """Each user's result bitwise its per-call tables' at two calls, the
    second copying nothing from the host."""
    inputs, per_call, under_test = user(*args)
    for k, x in enumerate(inputs):
        want = per_call(x)
        with monkeypatch.context() as m:
            if k:  # the tables were made at the first call
                m.setattr(torch, "as_tensor", _NoCopy(torch.as_tensor))
            got = under_test(x)
        assert _equal(got, want)


def test_device_tables_made_inside_a_capture_raise():
    """A table first asked for inside a capture would cross from the host
    there: it raises; one made before is returned as made."""
    made = capture.device_tables(lambda device, n: torch.arange(n, device=device))
    first = made(torch.device("cpu"), 3)
    with as_captured():
        assert made(torch.device("cpu"), 3) is first
        with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
            made(torch.device("cpu"), 4)


def window_bundle(full_hw, low_hw, da_win, seed):
    """(ReducedWindowObs, truth (da_win, 69, *full_hw)) of seeded synthetic
    obs: 30 % of the cells observed in each slot, the obs the truth, the
    truth the background plus a smooth perturbation in every slot."""
    rr = np.random.default_rng(seed)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    xb = (m + s * rr.normal(size=(69, *full_hw))).astype(np.float32)
    bump = interp.resize_nearest(torch.from_numpy(rr.normal(size=(da_win, 69, *low_hw))
                                                  .astype(np.float32)), full_hw)
    gt = torch.from_numpy(xb)[None] + 0.02 * torch.from_numpy(s.astype(np.float32)) * bump
    H = torch.from_numpy((rr.random((da_win, 69, *full_hw)) < 0.3).astype(np.float32))
    R = torch.from_numpy((s[None] ** 2 * (0.5 + rr.random((da_win, 69, 1, 1))))
                         .astype(np.float32))
    full = cost_mod.ObsBundle(xb=torch.from_numpy(xb), yo=H * gt, H=H, R=R)
    return cost_mod.reduce_obs_window(full, low_hw), gt


# --- the graphed solve with a stand-in replay on the CPU --------------------


@contextlib.contextmanager
def as_captured():
    """Python run as a capture runs it: utils/capture.py::capturing holds,
    for the counters and spans (utils/trace.py) and the checkpoints."""
    real = capture.capturing
    capture.capturing = lambda: True
    try:
        yield
    finally:
        capture.capturing = real


class _Replay:
    """A captured graph's stand-in: replay runs the body eagerly, counting
    and spanning nothing as a replay runs no Python, and writes its outputs
    into the buffers the capture handed out."""

    def __init__(self, body, outs):
        self.body, self.outs = body, outs

    def replay(self):
        with trace.tallied(), as_captured():
            new = self.body()
        with torch.no_grad():
            for out, t in zip(self.outs, new):
                out.copy_(t)


def stand_in_capture(self):
    """SolveGraphs._capture's stand-in: each body run once as captured, its
    tally kept; no warm-up."""
    with trace.tallied() as self._vg_tally, as_captured():
        self._v, self._g = self._value_grad()
    with trace.tallied() as self._decode_tally, as_captured():
        self.state, self._jb, self._jo = self._decode()
    self._vg_graph = _Replay(self._value_grad, (self._v, self._g))
    self._decode_graph = _Replay(self._decode, (self.state, self._jb, self._jo))


def _bundles(full_hw, low_hw, seeds, device="cpu"):
    """(ReducedObs, truth) of seeded synthetic obs: 10 % of the columns
    observed with the README's obs errors, the truth the background plus
    a smooth perturbation."""
    from vaevar_tpu_torch.da import obs as obs_mod

    var = torch.as_tensor(obs_mod.obs_error_variance(0.005, 2), dtype=torch.float32,
                          device=device).reshape(1, -1, 1, 1)
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=device)[:, None, None]
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=device)[:, None, None]
    out = []
    for seed in seeds:
        g = torch.Generator(device=device).manual_seed(seed)
        xb = mean + std * torch.randn((69, *full_hw), generator=g, device=device)
        bump = torch.randn((69, *low_hw), generator=g, device=device)
        gt = xb + 0.02 * std * interp.resize_nearest(bump, full_hw)
        H = (torch.rand(full_hw, generator=g, device=device) < 0.1).float().expand(69, -1, -1)
        bundle = cost_mod.reduce_obs(
            cost_mod.ObsBundle(xb=xb, yo=(H * gt)[None], H=H[None], R=var), low_hw)
        out.append((bundle, gt[None]))
    return out


def _solve_all(solver, x0, bundles, nit):
    return [solver.solve(x0, b, nit=nit, gt=gt, verbose=False) for b, gt in bundles]


def _same_diag(a, b):
    for k in ("loss_reg", "loss_obs", "n_iters", "n_evals", "n_jvp", "n_restore"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("wrmse", "bias"):
        for u, v in zip(getattr(a, k), getattr(b, k)):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("linesearch", ["zoom", "jvp-zoom"])
def test_stand_in_replay_solves_bitwise_as_eager(monkeypatch, linesearch):
    monkeypatch.setattr(SolveGraphs, "_capture", stand_in_capture)
    decoder, c = _micro_decoder()
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_reduced(decoder)
    bundles = _bundles((32, 64), (16, 32), (11, 12, 13))
    x0 = torch.zeros((1, c, 16, 32))
    kw = dict(lbfgs_iters=4, history=4, linesearch=linesearch)
    eager = _solve_all(VariationalSolver(cost, to_state, parts, **kw), x0, bundles, 2)
    before = trace.counters()
    trace.enable()
    graphed = _solve_all(VariationalSolver(cost, to_state, parts, evaluations=SolveGraphs(
        cost, to_state, parts), **kw), x0, bundles, 2)
    recs = trace.records()
    trace.disable()
    added = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    for (ze, xe, de), (zg, xg, dg) in zip(eager, graphed):
        assert torch.equal(ze, zg) and torch.equal(xe, xg)
        _same_diag(de, dg)
    assert added["solve.graph_captures"] == 1
    # every value and gradient is a replay; a jvp probe stays eager
    assert added["lbfgs.graph_replays"] == added["lbfgs.probes"] - added.get("lbfgs.jvp", 0)
    names = Counter(r["name"] for r in recs)
    assert names["lbfgs.replay"] == added["lbfgs.graph_replays"]
    assert names["lbfgs.forward"] == names["lbfgs.backward"] == 0
    by_id = {r["id"]: r for r in recs}
    assert all(by_id[r["parent"]]["name"] == "lbfgs.probe"
               for r in recs if r["name"] == "lbfgs.replay")
    if linesearch == "jvp-zoom":  # (and one more jvp span: the solver's check of the cost)
        assert added["lbfgs.jvp"] > 0


def test_stand_in_replay_without_truth_and_a_new_shape(monkeypatch):
    """Without diagnostics the analysis is one decode replay; a bundle of
    another grid captures again."""
    monkeypatch.setattr(SolveGraphs, "_capture", stand_in_capture)
    decoder, c = _micro_decoder()
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_reduced(decoder)
    graphs = SolveGraphs(cost, to_state, parts)
    eager = VariationalSolver(cost, to_state, parts, lbfgs_iters=3, history=3)
    graphed = VariationalSolver(cost, to_state, parts, lbfgs_iters=3, history=3, evaluations=graphs)
    x0 = torch.zeros((1, c, 16, 32))
    before = trace.counters().get("solve.graph_captures", 0)
    for full_hw in ((32, 64), (32, 64), (48, 96)):
        (bundle, _), = _bundles(full_hw, (16, 32), (5,))
        ze, xe, de = eager.solve(x0, bundle, nit=1, verbose=False)
        zg, xg, dg = graphed.solve(x0, bundle, nit=1, verbose=False)
        assert torch.equal(ze, zg) and torch.equal(xe, xg) and xg.shape[-2:] == full_hw
        assert xg.data_ptr() != graphs.state.data_ptr()
        _same_diag(de, dg)
    assert trace.counters()["solve.graph_captures"] - before == 2


def _scaled(state, factor):
    return {k: t * factor if t.is_floating_point() else t for k, t in state.items()}


def test_stand_in_load_keeps_held_copies_current(monkeypatch):
    """After an in-place reload of the decoder's weights, `load` remakes its
    held copies in place without capturing again, so the replay (which
    would raise on a stale copy: it runs as captured) gives the eager
    value and gradient at the new weights; where a copy cannot be remade in
    place, `load` captures again."""
    monkeypatch.setattr(SolveGraphs, "_capture", stand_in_capture)
    decoder, c = _micro_decoder(dtype=torch.bfloat16)
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_reduced(decoder)
    (bundle, _), = _bundles((32, 64), (16, 32), (5,))
    x0 = torch.zeros((1, c, 16, 32))
    z = 0.3 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(9))
    lbfgs.value_and_grad(lambda q: cost(q, bundle), z)  # the warm-up's eager run
    graphs = SolveGraphs(cost, to_state, parts, models=[decoder, None])
    graphs.load(x0, bundle)
    v0, _ = graphs.value_and_grad(z)
    copies = {id(e.copy) for m in decoder.modules() for e in m.__dict__.get("_held", {}).values()}
    decoder.load_state_dict(_scaled(decoder.state_dict(), 1.5))
    before = trace.counters()
    graphs.load(x0, bundle)
    added = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert added.get("solve.graph_captures", 0) == 0
    assert added["lgunet.cast_made"] == _n_held(decoder) == len(copies)
    assert copies == {id(e.copy) for m in decoder.modules()
                      for e in m.__dict__.get("_held", {}).values()}
    v, g = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
    vg, gg = graphs.value_and_grad(z)
    assert vg == v != v0 and torch.equal(gg, g)
    monkeypatch.setattr(graphs_mod, "refresh_held", lambda model: False)
    before = trace.counters()["solve.graph_captures"]
    graphs.load(x0, bundle)
    assert trace.counters()["solve.graph_captures"] - before == 1


# --- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def card_decoder():
    """The production decoder (VAE_DECODER, bf16 compute, f32 weights drawn
    from torch's default initialisation) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # as run_da
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    cfg = cfgs.VAE_DECODER.replace(dtype=torch.bfloat16)
    return LGUnet(cfg).to("cuda").eval().requires_grad_(False)


@pytest.fixture(scope="module")
def card(card_decoder):
    """The production decoder's reduced cost on the card, with seeded obs at
    721x1440 reduced onto the 128x256 latent grid."""
    decoder = card_decoder
    cfg = decoder.cfg
    cost, to_state, parts = cost_mod.make_vae4dvar_cost_reduced(decoder)
    bundles = _bundles((721, 1440), (128, 256), (21, 22, 23), device="cuda")
    x0 = torch.zeros((1, sum(cfg.inchans_list), 128, 256), device="cuda")
    return cost, to_state, parts, bundles, x0


def _agree(got, want, what):
    """Bitwise, or within bf16's rounding (2^-8 of the largest entry) where
    cuBLAS picked another algorithm under capture; prints which."""
    if torch.equal(got, want):
        print(f"{what}: bitwise equal")
        return
    err = float((got - want).abs().max() / want.abs().max())
    print(f"{what}: max error {err:.3g} of the largest entry")
    assert err <= 2 ** -8, (what, err)


@pytest.mark.gpu
def test_card_replayed_value_and_gradient(card):
    cost, to_state, parts, bundles, x0 = card
    bundle, _ = bundles[0]
    graphs = SolveGraphs(cost, to_state, parts)
    graphs.load(x0, bundle)
    g = torch.Generator(device="cuda").manual_seed(4)
    for _ in range(2):
        z = 0.3 * torch.randn(x0.shape, generator=g, device="cuda")
        before = trace.counters().get("lgunet.cast_held", 0)
        v, grad = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
        held_e = trace.counters()["lgunet.cast_held"] - before
        vg, gradg = graphs.value_and_grad(z)
        held_g = trace.counters()["lgunet.cast_held"] - before - held_e
        print(f"value eager {v!r}, replayed {vg!r}; lgunet.cast_held eager {held_e}, "
              f"replayed {held_g}")
        assert abs(vg - v) <= 1e-6 * abs(v)
        _agree(gradg, grad, "gradient")
        assert held_g == held_e > 0


@pytest.mark.gpu
def test_card_decode_graph_is_to_state(card):
    cost, to_state, parts, bundles, x0 = card
    bundle, _ = bundles[1]
    graphs = SolveGraphs(cost, to_state, parts)
    graphs.load(x0, bundle)
    z = 0.3 * torch.randn(x0.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                          device="cuda")
    with torch.no_grad():
        want, (jb, jo) = to_state(z, bundle), parts(z, bundle)
    state, jbg, jog = graphs.decode(z)
    _agree(state, want, "decoded state")
    assert float(jbg) == float(jb)
    assert abs(float(jog) - float(jo)) <= 1e-5 * abs(float(jo))


@pytest.mark.gpu
def test_card_three_solves_one_capture(card):
    cost, to_state, parts, bundles, x0 = card
    kw = dict(lbfgs_iters=10, history=10, linesearch="zoom")
    eager = _solve_all(VariationalSolver(cost, to_state, parts, **kw), x0, bundles, 2)
    before = trace.counters()
    graphed = _solve_all(VariationalSolver(cost, to_state, parts, evaluations=SolveGraphs(
        cost, to_state, parts), **kw), x0, bundles, 2)
    added = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert added["solve.graph_captures"] == 1
    assert added["lbfgs.graph_replays"] == added["lbfgs.probes"]
    for (_, _, de), (_, _, dg) in zip(eager, graphed):
        print(f"evals {de.n_evals} / {dg.n_evals}; Jb {de.loss_reg[-1]!r} / "
              f"{dg.loss_reg[-1]!r}; Jo {de.loss_obs[-1]!r} / {dg.loss_obs[-1]!r}")
        assert de.n_evals == dg.n_evals
        for a, b in zip(de.loss_reg + de.loss_obs, dg.loss_reg + dg.loss_obs):
            assert abs(a - b) <= 1e-5 * abs(a), (a, b)
        assert dg.loss_obs[-1] < dg.loss_obs[0]


@pytest.mark.gpu
def test_card_capture_beside_a_worker_stream(card):
    """The obs prefetch's pattern on another thread during the capture:
    pageable host-to-device copies, kernels and event waits on a stream of
    its own."""
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
    z = 0.3 * torch.randn(x0.shape, generator=torch.Generator(device="cuda").manual_seed(6),
                          device="cuda")
    v, grad = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
    vg, gradg = graphs.value_and_grad(z)
    assert abs(vg - v) <= 1e-6 * abs(v)
    _agree(gradg, grad, "gradient after a capture beside a worker")


@pytest.mark.gpu
def test_card_weights_reloaded_in_place(card, card_decoder):
    """An in-place reload of the decoder's weights between solves: `load`
    remakes the held copies where the graphs read them, with no new
    capture, and the replay gives the eager value and gradient at the new
    weights bitwise."""
    cost, to_state, parts, bundles, x0 = card
    decoder = card_decoder
    bundle, _ = bundles[0]
    z = 0.3 * torch.randn(x0.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                          device="cuda")
    graphs = SolveGraphs(cost, to_state, parts, models=[decoder])
    graphs.load(x0, bundle)
    v0, _ = graphs.value_and_grad(z)
    original = {k: t.clone() for k, t in decoder.state_dict().items()}
    try:
        decoder.load_state_dict(_scaled(original, 1.01))
        before = trace.counters()
        graphs.load(x0, bundle)
        added = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
        print(f"reload: {added.get('lgunet.cast_made', 0)} copies remade of "
              f"{_n_held(decoder)}, {added.get('solve.graph_captures', 0)} captures")
        assert added.get("solve.graph_captures", 0) == 0
        assert added["lgunet.cast_made"] == _n_held(decoder) > 0
        v, grad = lbfgs.value_and_grad(lambda q: cost(q, bundle), z)
        vg, gradg = graphs.value_and_grad(z)
        print(f"value before the reload {v0!r}; eager {v!r}, replayed {vg!r}")
        assert vg == v != v0
        assert torch.equal(gradg, grad)
    finally:
        decoder.load_state_dict(original)


@pytest.mark.gpu
def test_card_first_held_copy_inside_a_capture_raises(card):
    model, c = _micro_decoder(dtype=torch.bfloat16)
    model = model.cuda()
    x = torch.zeros((1, c, 16, 32), device="cuda")
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            model(x)
