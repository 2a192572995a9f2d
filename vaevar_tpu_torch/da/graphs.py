"""How a variational solve evaluates its cost (da/cost.py's triple), decided
here alone: `solve_evaluations` picks `SolveGraphs` (CUDA graphs) or
`Evaluations` (op by op), one interface for the solver and L-BFGS:
`load(x0, bundle)` once per solve, `value_and_grad(x)` and
`value_and_slope(x, u)` (lbfgs.Eager's), `decode(x)` -> (state, Jb, Jo),
and last `analysis(x)`, the analysis state as a tensor the caller owns.

An L-BFGS probe of the reduced vae4dvar cost (cost.
make_vae4dvar_cost_reduced, or make_vae4dvar_cost_window_reduced with a
flow model) runs the VAE decoder's forward and backward, some 5000 small
kernels, and in a window also five flow steps, their checkpoints'
recompute and their backward, some 58 000; each is launched from Python,
so eagerly the host takes ~150 ms (window: ~2.9 s) a probe to launch ~25 ms
(~0.25 s) of device work. Every input of those launches has a fixed shape
for the life of a solver (the control z, the bundle's fields), and the
models' weights are frozen, so on a CUDA device `SolveGraphs` captures two
CUDA graphs once and replays them. A frozen LGUnet casts its weights to
bf16 once and holds the copies (models/lgunet.py::held), so the graphs read
the held copies and cast no weight; a replay runs no Python, so `load`
re-checks them before each solve (lgunet.refresh_held): one whose weights
changed (a reload, an in-place write) is remade in place, where the graphs
read it, and one that cannot be (a model moved to another device or
reshaped) makes `load` capture again. The graphs:

- the value and gradient, `v = cost(x, bundle)`, `g = dv/dx`: one replay per
  probe, the gradient copied out of the graph's buffer;
- the decode, `to_state(x, bundle)` with `cost_parts(x, bundle)` (Jb, Jo),
  no grad: one replay per diagnostics, and for the analysis unless the last
  diagnostics decoded that x.

A jvp probe stays eager on every path. The graphs read static buffers: x,
and the bundle's fields (a cost.ReducedObs or a cost.ReducedWindowObs, of
the bundle's own type), which `load` fills for each solve. The first `load`
(and one whose shapes, dtypes or device differ) warms both up on a side
stream and captures them into one memory pool, which they share as they
never replay at the same time. The capture runs with
`capture_error_mode="thread_local"`, so work that another thread queues on
its own stream meanwhile (the cycler's obs prefetch) does not break it.
Nothing inside the captured region copies between host and device or
waits for the device: the cost's tables cross to a device once
(utils/capture.py::device_tables), the held weight copies are made by the
warm-up (one first asked for inside the capture raises), and the
activation checkpoints (LGUnet's block remat, the window's step
checkpoint) keep no RNG state under a capture (utils/capture.py::checkpoint).

The rest stays eager: the collectives (gloo, nccl) of a mesh or a
tensor-parallel model are not captured, the CPU has no graphs, and sc4dvar
(the CVT's FFTs) and the full-grid costs (real obs, with augment_levels'
per-call copy; a window without a flow model) are not shown to capture.

Counters (utils/trace.py, always on): `lbfgs.graph_replays`, one per
replayed probe; `solve.graph_captures`, one per capture. The counters the
captured bodies count (`window.rollout_steps`, `window.flow_forwards`,
`flash.*`, `lgunet.cast_held`) are tallied at the capture (trace.tallied)
and added at each replay, so they read what the eager solve reads; the
capture itself counts nothing, and the warm-up runs count as the eager runs
they are. Spans:
`lbfgs.replay` around a replayed probe's copy in, replay and copy out
(inside `lbfgs.probe`, where an eager probe has `lbfgs.forward` and
`lbfgs.backward`); a body's device spans (the window's `window.step`, a
flow step or its recompute) are recorded from the graph's own timing
events after each replay while tracing is on (trace.Tally.replayed), its
host spans (`window.rollout`) not at all.
"""
from __future__ import annotations

from typing import Callable

import torch

from vaevar_tpu_torch.da.lbfgs import Eager, _host
from vaevar_tpu_torch.models.lgunet import refresh_held
from vaevar_tpu_torch.parallel.tensor_parallel import is_tensor_parallel
from vaevar_tpu_torch.utils import trace

_WARMUP = 2  # eager runs of each body on a side stream before the capture


def solve_evaluations(cost: Callable, to_state: Callable, cost_parts: Callable, *,
                      mode: str, form: str, mesh, models, device) -> Evaluations:
    """`SolveGraphs` for the reduced vae4dvar cost (`mode` "vae4dvar", `form`
    "3dvar" or "window", not "full") with no `mesh` and no tensor-parallel
    model among `models`, on a CUDA `device`; else `Evaluations`."""
    graphed = (mode == "vae4dvar" and form in ("3dvar", "window") and mesh is None
               and not any(m is not None and is_tensor_parallel(m) for m in models)
               and torch.device(device).type == "cuda")
    if graphed:
        return SolveGraphs(cost, to_state, cost_parts, models=models)
    return Evaluations(cost, to_state, cost_parts)


class Evaluations(Eager):
    """A cost triple's evaluations, op by op, on the bundle of the last
    `load` (`fun` is the cost on it)."""

    def __init__(self, cost: Callable, to_state: Callable, cost_parts: Callable):
        super().__init__(None)
        self.cost, self.to_state, self.cost_parts = cost, to_state, cost_parts

    def load(self, x0, bundle):
        self.bundle = bundle
        self.fun = lambda x: self.cost(x, bundle)

    @torch.no_grad()
    def decode(self, x):
        return self.to_state(x, self.bundle), *self.cost_parts(x, self.bundle)

    @torch.no_grad()
    def analysis(self, x):
        """The analysis state at x; the solve's last call lets the bundle go."""
        state = self.to_state(x, self.bundle)
        del self.bundle, self.fun
        return state


class SolveGraphs(Evaluations):
    """The value-and-gradient and decode graphs of one reduced vae4dvar cost
    on one CUDA device, on static copies of the bundle; `models` are the
    networks the cost runs (None entries skipped), whose held weight copies
    the graphs read."""

    _signature = None  # of the captured (x0, bundle)

    def __init__(self, cost: Callable, to_state: Callable, cost_parts: Callable,
                 models=()):
        super().__init__(cost, to_state, cost_parts)
        self.models = [m for m in models if m is not None]

    def load(self, x0, bundle):
        """Bring the models' held weight copies up to date and copy a solve's
        bundle into the static buffers; capture both graphs at the first
        load, at one of other shapes, dtypes or device, and where a held
        copy could not be remade in place."""
        self._decoded = None  # the x whose decode the graph's buffers hold
        sig = tuple((tuple(t.shape), t.dtype, t.device) for t in (x0, *bundle))
        in_place = all([refresh_held(m) for m in self.models])
        if sig == self._signature and in_place:
            with torch.no_grad():
                for static, t in zip(self.bundle, bundle):
                    static.copy_(t)
            return
        self._signature = None
        self._x = x0.detach().clone().requires_grad_(True)
        super().load(x0, type(bundle)(*(t.detach().clone() for t in bundle)))
        self._capture()
        self._signature = sig
        trace.count("solve.graph_captures")

    def _value_grad(self):
        with torch.enable_grad():
            v = self.fun(self._x)
            (g,) = torch.autograd.grad(v, self._x)
        return v.detach(), g

    def _decode(self):
        return super().decode(self._x)

    def _capture(self):
        """Warm both bodies up on a side stream, then capture them
        (torch.cuda.graphs' recipe)."""
        device = self._x.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self._value_grad()
                self._decode()
        torch.cuda.current_stream(device).wait_stream(side)
        self._vg_graph = torch.cuda.CUDAGraph()
        with trace.tallied() as self._vg_tally, torch.cuda.graph(
                self._vg_graph, capture_error_mode="thread_local"):
            self._v, self._g = self._value_grad()
        self._decode_graph = torch.cuda.CUDAGraph()
        with trace.tallied() as self._decode_tally, torch.cuda.graph(
                self._decode_graph, pool=self._vg_graph.pool(),
                capture_error_mode="thread_local"):
            self.state, self._jb, self._jo = self._decode()

    def value_and_grad(self, x):
        """(value as np.float32, gradient) of the cost at x on the loaded
        bundle, by one replay: lbfgs.value_and_grad's contract. The gradient
        is a copy: L-BFGS keeps it past the next replay."""
        trace.count("lbfgs.graph_replays")
        with trace.span("lbfgs.replay"):
            with torch.no_grad():
                self._x.copy_(x)
            self._vg_graph.replay()
            g = self._g.clone()
        v = _host(self._v)
        self._vg_tally.replayed()
        self._decoded = None
        return v, g

    def decode(self, x):
        """(state, Jb, Jo) at x on the loaded bundle, by one replay: the
        graph's own buffers (`state` among them), valid until the next
        replay of either graph."""
        with torch.no_grad():
            self._x.copy_(x)
        self._decode_graph.replay()
        self._decode_tally.replayed()
        self._decoded = x
        return self.state, self._jb, self._jo

    def analysis(self, x):
        """A copy of the decoded state at x: one decode replay, none where
        the last replay decoded this x."""
        if x is not self._decoded:
            self.decode(x)
        self._decoded = None
        return self.state.clone()
