"""Driver of a forecast-training cell: the port's make_forecast_train_step.

Set-up: the model from the seed (weights.draw), the trainable and AdamW
state of `init_fn`, a pool of normalized input pairs of the synthetic truth
on the device (consecutive 6 h frames; step i takes pair i mod pool), then
3 steps through the window's own call (`train_step` and one `float(loss)`,
as train_forecast runs them) on 3 different pairs. `setup_s` runs from the
process's start to the end of the third. The window then takes steps on
the same trainable until the first step end after --seconds: `s_per_step`
is its length over its steps. With --trace 1, 3 more steps run under the
profiler. `peak_mem_gib.train` leaves out the pool: each step's batch is
a copy of its pair (`torch.cat`), which is what a loader would hold.

Check, once the window has closed and the program is freed: the plain
float32 reference (reference/) takes the same first 3 steps from the same
weights and pairs, and the program's records of them, taken in set-up off
the window's clock, are compared with its:

- `loss_gap`: the worst step's |loss - loss_ref| / |loss_ref|;
- `grad_gap`: by the worst leaf, the gap between the norms of the first
  gradient (the program's from AdamW's first moment after step 1, exp_avg
  / (1 - b1)) over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- `step_gap`: the same of the norms of each leaf's change over the 3
  steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf numbers (they move by round-off alone).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

import harness
import models
import weights
from metrics import _flops
from reference import channels
from reference import train as rtrain

CHECK_STEPS = 3
TRACE_STEPS = 3
SMALL_LEAF = 1e-3


def _pool(source, hw, n_frames, start_hours, dev):
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=dev)[:, None, None]
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=dev)[:, None, None]
    return [((source.state(start_hours + 6 * i) - mean) / std)[None] for i in range(n_frames)]


def _bounds(n, dev):
    return (torch.nn.Parameter(torch.full((1, n), 0.5, device=dev)),
            torch.nn.Parameter(torch.full((1, n), -10.0, device=dev)))


def run(ctx: harness.Ctx) -> harness.Outcome:
    from devtrace import DeviceTrace
    from synth import DeviceEra5
    from vaevar_tpu_torch.train import forecast_trainer as ft

    cfg, traffic, tr = ctx.config, ctx.cell["params"], ctx.config["train"]
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    hw = tuple(cfg["model"]["img_size"])
    b, n_pairs = tr["batch_size"], traffic["pool_pairs"]
    model = models.program_model(cfg["model"], ctx.seed, "forecast", dev).train()
    init_fn, train_step = ft.make_forecast_train_step(
        model, tr["loss_type"], lr=tr["lr"], total_steps=tr["total_steps"],
        out_shape=(2 * channels.N_CHANNELS, *hw))
    trainable, opt_state = init_fn()
    frames = _pool(DeviceEra5(hw, ctx.seed, dev), hw, n_pairs + b, traffic["start_hours"], dev)

    def batch(i):
        j = i % n_pairs
        return torch.cat(frames[j:j + b]), [torch.cat(frames[j + 1:j + 1 + b])]

    def step(i):
        nonlocal trainable, opt_state
        inp, tars = batch(i)
        trainable, opt_state, loss = train_step(trainable, opt_state, inp, tars)
        return float(loss)

    leaves = sorted((f"model.{n}", p) for n, p in model.named_parameters()) + [
        (k, trainable[k]) for k in ("max_logvar", "min_logvar")]
    losses = []
    for i in range(CHECK_STEPS):
        losses.append(step(i))
        if i == 0:
            b1 = opt_state.optimizer.defaults["betas"][0]
            state = opt_state.optimizer.state
            grads = {n: float(state[p]["exp_avg"].norm()) / (1 - b1) if p in state else 0.0
                     for n, p in leaves}
    changes = _changes(dict(leaves), model, ctx.seed, {"max_logvar": 0.5, "min_logvar": -10.0})

    t0 = time.perf_counter()
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = 0
    while True:
        step(CHECK_STEPS + steps)
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    held = sum(f.numel() * f.element_size() for f in frames)
    reading = None
    if ctx.trace and cuda:
        tracer = DeviceTrace(ctx.scratch)
        tracer.start("train step")
        for i in range(TRACE_STEPS):
            if i:
                tracer.mark("train step")
            step(CHECK_STEPS + steps + i)
        reading = tracer.stop()
    mc = cfg["model"]
    data = {"s_per_step": window_s / steps, "trace": reading, "peak_window_bytes": peak_window,
            "harness_bytes": held,
            "flops_step": 3 * _flops.lgunet_forward_flops(mc, b),
            "flash_shape": (b, mc["lg_heads"][0],
                            (hw[0] // mc["stride"][0] // 2 ** (len(mc["enc_depths"]) - 1))
                            * (hw[1] // mc["stride"][1] // 2 ** (len(mc["enc_depths"]) - 1)),
                            mc["embed_dim"] // mc["lg_heads"][0])}
    e2e = {"setup_s": t0 - ctx.start, "s_per_step": window_s / steps}
    del trainable, opt_state, model, leaves, train_step, init_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    program = {"losses": losses, "grads": grads, "changes": changes}
    ref = reference_steps(ctx, cfg, batch, "fp32")
    checks = compare(program, ref, ctx.cell["limits"])
    control = (compare(reference_steps(ctx, cfg, batch, "fp8"), ref, ctx.cell["limits"])
               if ctx.control else [])
    failed = sum(not math.isfinite(v) for v in losses)
    return harness.Outcome(e2e=e2e, data=data, checks=checks, attempted=steps,
                           failed=failed, memory_peak_bytes=max(peak_setup, peak_window),
                           trace=reading, control_checks=control)


@torch.no_grad()
def _changes(params: dict, model, seed, bounds_init) -> dict:
    """{leaf: norm of its change since the draw}: the model's leaves against
    the draw of (seed, "forecast"), made anew leaf by leaf, and the logvar
    bounds against their initial values."""
    out = {f"model.{n}": float((params[f"model.{n}"] - v).norm())
           for n, v in weights.values(model, seed, "forecast")}
    for k, v0 in bounds_init.items():
        out[k] = float((params[k] - v0).norm())
    return out


def reference_steps(ctx, cfg, batch, precision) -> dict:
    """The reference's first CHECK_STEPS steps from the same weights and
    pairs: {"losses", "grads" (first step), "changes"}."""
    dev = torch.device(ctx.device)
    tr = cfg["train"]
    model = models.reference_model(cfg["model"], ctx.seed, "forecast", dev).train()
    hw = tuple(cfg["model"]["img_size"])
    mx, mn = _bounds(channels.N_CHANNELS * hw[0] * hw[1], dev)
    leaves = sorted((f"model.{n}", p) for n, p in model.named_parameters()) + [
        ("max_logvar", mx), ("min_logvar", mn)]
    opt = rtrain.AdamW([p for _, p in leaves], tr["lr"], tr["total_steps"])
    losses = []
    for i in range(CHECK_STEPS):
        inp, tars = batch(i)
        for _, p in leaves:
            p.grad = None
        loss = rtrain.possloss(model(inp, precision), tars[0], mx, mn)
        loss.backward()
        losses.append(float(loss.detach()))
        if i == 0:
            grads = {n: float(p.grad.norm()) for n, p in leaves}
        opt.step()
    for _, p in leaves:
        p.grad = None
    changes = _changes(dict(leaves), model, ctx.seed, {"max_logvar": 0.5, "min_logvar": -10.0})
    del model, opt, leaves, mx, mn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "changes": changes}


def leaf_gap(got: dict, want: dict, kept) -> float:
    """The worst kept leaf's |got - want| over max(want, the median leaf's
    want)."""
    med = statistics.median(want[n] for n in kept)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in kept)


def compare(got: dict, ref: dict, limits: dict) -> list:
    med = statistics.median(ref["grads"].values())
    kept = [n for n, g in ref["grads"].items() if g >= SMALL_LEAF * med]
    loss = max(abs(a - r) / abs(r) for a, r in zip(got["losses"], ref["losses"]))
    return [harness.Check("loss_gap", loss, limits["loss_gap"]),
            harness.Check("grad_gap", leaf_gap(got["grads"], ref["grads"], kept),
                          limits["grad_gap"]),
            harness.Check("step_gap", leaf_gap(got["changes"], ref["changes"], kept),
                          limits["step_gap"])]
