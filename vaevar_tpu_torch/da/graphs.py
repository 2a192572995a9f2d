"""The reduced vae4dvar solve's evaluations as CUDA graphs: 3D-Var, and the
4D-Var window with the flow model rolled out inside J.

An L-BFGS probe of the reduced vae4dvar cost (da/cost.py::
make_vae4dvar_cost_reduced, or make_vae4dvar_cost_window_reduced with a
flow model) runs the VAE decoder's forward and backward, some 5000 small
kernels, and in a window also five flow steps, their checkpoints'
recompute and their backward, some 58 000; each is launched from Python,
so eagerly the host takes ~150 ms (window: ~2.9 s) a probe to launch ~25 ms
(~0.25 s) of device work. Every input of those launches has a fixed shape
for the life of a solver (the control z, the bundle's fields), and the
models' weights are frozen, so `SolveGraphs` captures two CUDA graphs once
and replays them:

- the value and gradient, `v = cost(x, bundle)`, `g = dv/dx`: one replay per
  probe (`value_and_grad`, lbfgs.value_and_grad's contract), the
  gradient copied out of the graph's buffer;
- the decode, `to_state(x, bundle)` with `cost_parts(x, bundle)` (Jb, Jo),
  no grad: one replay per diagnostics and for the analysis (`decode`).

Both read static buffers: x, and the bundle's fields (a cost.ReducedObs or
a cost.ReducedWindowObs, of the bundle's own type), which `load` fills for
each solve. The first `load` (and one whose shapes, dtypes or device
differ) warms both up on a side stream and captures them into one memory
pool, which they share as they never replay at the same time. The capture
runs with `capture_error_mode="thread_local"`, so work that another thread
queues on its own stream meanwhile (the cycler's obs prefetch) does not
break it. Nothing inside the captured region copies between host and
device or waits for the device: the cost's tables are built once per
device (cost._increment_fn, the window's gathers, dynamics.make_integrate,
ops/interp.py::resize_nearest), and the activation checkpoints (LGUnet's
block remat, the window's step checkpoint) keep no RNG state under a
capture (utils/capture.py).

The cycler hands a solver a `SolveGraphs` where the rule of
`CycledDA._graphed` holds: a reduced vae4dvar cost (3D-Var, or a window
with its flow model), no mesh and no tensor-parallel model, a CUDA device.
Elsewhere the solve stays eager.

Counters (utils/trace.py, always on): `lbfgs.graph_replays`, one per
graphed probe; `solve.graph_captures`, one per capture. The counters the
captured bodies count (`window.rollout_steps`, `window.flow_forwards`,
`flash.*`) are tallied at the capture (trace.tallied) and added at each
replay, so they read what the eager solve reads; the capture itself counts
nothing, and the warm-up runs count as the eager runs they are. Spans:
`lbfgs.replay` around a graphed probe's copy in, replay and copy out
(inside `lbfgs.probe`, where an eager probe has `lbfgs.forward` and
`lbfgs.backward`); a body's device spans (the window's `window.step`, a
flow step or its recompute) are recorded from the graph's own timing
events after each replay while tracing is on (trace.Tally.replayed), its
host spans (`window.rollout`) not at all.
"""

from __future__ import annotations

from typing import Callable

import torch

from vaevar_tpu_torch.da.lbfgs import _host
from vaevar_tpu_torch.utils import trace

_WARMUP = 2  # eager runs of each body on a side stream before the capture


def _signature(x0, bundle) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in (x0, *bundle))


class SolveGraphs:
    """The value-and-gradient and decode graphs of one reduced vae4dvar cost
    (`cost`, `to_state`, `cost_parts` of cost.make_vae4dvar_cost_reduced or
    cost.make_vae4dvar_cost_window_reduced) on one CUDA device."""

    def __init__(self, cost: Callable, to_state: Callable, cost_parts: Callable):
        self.cost = cost
        self.to_state = to_state
        self.cost_parts = cost_parts
        self._signature = None

    def load(self, x0, bundle):
        """Copy a solve's bundle into the static buffers; capture both
        graphs at the first load, and again where a shape, dtype or device
        differs from the captured one's."""
        sig = _signature(x0, bundle)
        if sig == self._signature:
            with torch.no_grad():
                for static, t in zip(self._bundle, bundle):
                    static.copy_(t)
            return
        self._signature = None
        self._x = x0.detach().clone().requires_grad_(True)
        self._bundle = type(bundle)(*(t.detach().clone() for t in bundle))
        self._capture()
        self._signature = sig
        trace.count("solve.graph_captures")

    def _value_grad(self):
        with torch.enable_grad():
            v = self.cost(self._x, self._bundle)
            (g,) = torch.autograd.grad(v, self._x)
        return v.detach(), g

    @torch.no_grad()
    def _decode(self):
        return (self.to_state(self._x, self._bundle),
                *self.cost_parts(self._x, self._bundle))

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

    def value_and_grad(self, fun: Callable, x):
        """(value as np.float32, gradient) of the cost at x on the loaded
        bundle, by one replay: lbfgs.value_and_grad's contract, where `fun`
        is the solve's cost on that bundle, captured and so not called. The
        gradient is a copy: L-BFGS keeps it past the next replay."""
        trace.count("lbfgs.graph_replays")
        with trace.span("lbfgs.replay"):
            with torch.no_grad():
                self._x.copy_(x)
            self._vg_graph.replay()
            g = self._g.clone()
        v = _host(self._v)
        self._vg_tally.replayed()
        return v, g

    def decode(self, x):
        """(state, Jb, Jo) at x on the loaded bundle, by one replay: the
        graph's own buffers (`state` among them), valid until the next
        replay of either graph."""
        with torch.no_grad():
            self._x.copy_(x)
        self._decode_graph.replay()
        self._decode_tally.replayed()
        return self.state, self._jb, self._jo
