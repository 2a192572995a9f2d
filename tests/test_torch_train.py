"""The port's forecast trainer against the JAX package's.

Weights cross over through the bridge (utils/port_jax.py); inputs and
targets come from a numpy seed. Micro configs with two variable groups
(4 + 13 channels, as tests/test_training.py) at 16x32, in f32:
- rope with flash_min_seq=16 and remat: the full-grid LG stage and the
  unshifted encoder windows run flash attention, through the custom VJP
  (the plain backward on the CPU) under activation checkpointing;
- relbias: the old-gen dense window attention.

Tolerances, with the reason:
- loss: rtol 1e-5 (f32 forward, a few ulp per layer; the loss averages).
- gradients: atol 1e-4 x the largest |gradient| of the whole trainable,
  rtol 1e-3. The forward differs by f32 round-off, and a backward through
  ~30 layers grows it; the tiniest entries (1e-7 of the largest) are
  compared against that absolute floor.
- trainable after 2 AdamW steps: atol 2.5 x lr. Adam divides each
  gradient by its own RMS, so an entry whose gradient is round-off (sign
  undecided between the two frameworks) can step +lr in one and -lr in
  the other; every entry moves by at most ~lr per step, so 2 steps bound
  the gap by 2 lr (weight decay adds lr x 1e-4 x |p|).
- calculate_q and the rollout: rtol 1e-4, atol 1e-6 (f32 forward).
- the losses alone: rtol 1e-5 (f32 means over ~1.7e4 terms summed in
  another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import model_pair, rand
from vaevar_tpu import config as C
from vaevar_tpu.train import forecast_trainer as jft
from vaevar_tpu.utils import metrics as jmetrics
from vaevar_tpu_torch.ops import flash_attn as fa
from vaevar_tpu_torch.train import checkpoint as tckpt
from vaevar_tpu_torch.train import forecast_trainer as tft
from vaevar_tpu_torch.utils import metrics as tmetrics
from vaevar_tpu_torch.utils.port_jax import forecast_trainable_from_flax

torch.set_num_threads(1)

HW = (16, 32)
NC = 17
GROUPS = dict(inchans_list=(4, 13), outchans_list=(8, 26))
CONFIGS = {
    "rope_flash_remat": C.micro_config(img_size=HW, flash_min_seq=16, remat=True, **GROUPS),
    "relbias": C.micro_config(img_size=HW, attn_type="relbias", **GROUPS),
}
LR, TOTAL = 1e-4, 4


def _batch(seed, b=1):
    return rand((b, NC, *HW), seed), [rand((b, NC, *HW), seed + 1)]


def _run_jax(jm, params, loss_type, batches):
    """JAX: (losses, gradients of the first step, trainable after each step).
    The gradients are read from optax's first Adam moment, which after one
    update is (1 - b1) g."""
    init_fn, step = jft.make_forecast_train_step(
        jm.apply, loss_type, lr=LR, total_steps=TOTAL, out_shape=(2 * NC, *HW))
    trainable, opt_state = init_fn(params)
    step_j = jax.jit(step)
    losses, states, grads = [], [], None
    for inp, tars in batches:
        trainable, opt_state, loss = step_j(trainable, opt_state, jnp.asarray(inp),
                                            [jnp.asarray(t) for t in tars])
        losses.append(float(loss))
        states.append(jax.tree.map(np.asarray, trainable))
        if grads is None:
            grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), opt_state[0].mu)
    return losses, grads, states


def _port_trainable(trainable):
    out = {f"model.{k}": v.detach().numpy() for k, v in trainable["model"].state_dict().items()}
    out.update({k: v.detach().numpy() for k, v in trainable.items() if k != "model"})
    return out


def _jax_in_port_layout(tree, cfg):
    ported = forecast_trainable_from_flax(tree, cfg)
    out = {f"model.{k}": v.numpy() for k, v in ported["model"].items()}
    out.update({k: v.numpy() for k, v in ported.items() if k != "model"})
    return out


@pytest.mark.parametrize("name,loss_type", [("rope_flash_remat", "Possloss"),
                                            ("relbias", "Possloss"),
                                            ("relbias", "LpLoss")])
def test_train_step_matches_jax(name, loss_type, monkeypatch):
    cfg = CONFIGS[name]
    jm, params, tm = model_pair(cfg)
    batches = [_batch(10), _batch(20)]
    j_losses, j_grads, j_states = _run_jax(jm, params, loss_type, batches)

    bwd_calls = []
    real = fa.flash_attention_bwd_plain
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a: bwd_calls.append(1) or real(*a))
    init_fn, step = tft.make_forecast_train_step(
        tm.train(), loss_type, lr=LR, total_steps=TOTAL, out_shape=(2 * NC, *HW))
    trainable, opt_state = init_fn()
    t_losses, t_grads = [], None
    for inp, tars in batches:
        trainable, opt_state, loss = step(trainable, opt_state, torch.from_numpy(inp),
                                          [torch.from_numpy(t) for t in tars])
        t_losses.append(float(loss))
        if t_grads is None:
            t_grads = {f"model.{k}": p.grad.numpy().copy()
                       for k, p in trainable["model"].named_parameters()}
            t_grads.update({k: v.grad.numpy().copy() for k, v in trainable.items()
                            if k != "model"})
            t_state1 = _port_trainable(trainable)
    if name.startswith("rope"):
        assert bwd_calls, "the flash stage's backward did not run"

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    want = _jax_in_port_layout(j_grads, cfg)
    assert sorted(want) == sorted(t_grads)
    scale = max(np.abs(g).max() for g in want.values())
    for k in want:
        np.testing.assert_allclose(t_grads[k], want[k], rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    for got, state in ((t_state1, j_states[0]), (_port_trainable(trainable), j_states[1])):
        want = _jax_in_port_layout(state, cfg)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2.5 * LR, err_msg=k)


def test_lr_schedule_matches_optax():
    """Update k uses optax.cosine_decay_schedule(lr, T)(k), also past T;
    AdamW with b2 0.9, eps 1e-8 and weight decay 1e-4 on every parameter."""
    T, lr = 5, 3e-3
    sched = optax.cosine_decay_schedule(lr, T)
    model = torch.nn.Linear(4, 4)
    init_fn, step = tft.make_forecast_train_step(model, "LpLoss", lr=lr, total_steps=T)
    trainable, opt_state = init_fn()
    group = opt_state.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.9), 1e-8, 1e-4)
    x = torch.from_numpy(rand((2, 4), 1))
    for s in range(T + 3):
        assert group["lr"] == pytest.approx(float(sched(s)), rel=1e-6, abs=1e-12), s
        step(trainable, opt_state, x, [x + 1])


class _Scale(torch.nn.Module):
    """pred = inp * w: a model whose gradients are all well away from 0."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))

    def forward(self, x):
        return x * self.w


def test_adamw_matches_optax():
    """T updates of the port's optimizer and of optax.adamw(
    cosine_decay_schedule(lr, T), b1=0.9, b2=0.9) (weight decay 1e-4 on
    every leaf) on the same model and data move the parameters alike: rtol
    1e-4 on the displacement, a few f32 ulp of the per-step update. At
    |w| ~ 20 the weight decay is ~2e-3 of the displacement, so a missing or
    coupled decay, another b2 or eps, or a schedule one step off shows."""
    shape, lr, T = (1, 3, 4, 8), 1e-2, 5
    w0, x, t = rand(shape, 60) + 20.0, rand(shape, 61), rand(shape, 62)
    init_fn, step = jft.make_forecast_train_step(lambda p, inp: inp * p["w"], "LpLoss",
                                                 lr=lr, total_steps=T)
    trainable, opt_state = init_fn({"w": jnp.asarray(w0)})
    for _ in range(T):
        trainable, opt_state, _ = step(trainable, opt_state, jnp.asarray(x), [jnp.asarray(t)])
    want = np.asarray(trainable["model"]["w"]) - w0
    model = _Scale(w0)
    init_fn, step = tft.make_forecast_train_step(model, "LpLoss", lr=lr, total_steps=T)
    trainable, opt_state = init_fn()
    for _ in range(T):
        step(trainable, opt_state, torch.from_numpy(x), [torch.from_numpy(t)])
    np.testing.assert_allclose(model.w.detach().numpy() - w0, want, rtol=1e-4, atol=1e-7)


def test_losses_match_jax():
    pred, tar = rand((2, 2 * NC, *HW), 1), rand((2, NC, *HW), 2)
    n = NC * HW[0] * HW[1]
    mx, mn = rand((1, n), 3, 0.3) + 0.5, rand((1, n), 4, 0.3) - 10.0
    for inc in (True, False):
        want = float(jft.poss_loss(jnp.asarray(pred), jnp.asarray(tar), jnp.asarray(mx),
                                   jnp.asarray(mn), inc))
        got = float(tft.poss_loss(*(torch.from_numpy(a) for a in (pred, tar, mx, mn)), inc))
        assert got == pytest.approx(want, rel=1e-5)
    want = float(jft.lp_loss(jnp.asarray(pred[:, :NC]), jnp.asarray(tar)))
    assert float(tft.lp_loss(torch.from_numpy(pred[:, :NC]), torch.from_numpy(tar))) \
        == pytest.approx(want, rel=1e-5)


def test_calculate_q_and_rollout_match_jax():
    cfg = CONFIGS["rope_flash_remat"]
    jm, params, tm = model_pair(cfg)
    pairs = [(rand((1, NC, *HW), 30 + i), rand((1, NC, *HW), 40 + i)) for i in range(2)]
    want = jft.calculate_q(jm.apply, params, pairs)
    got = tft.calculate_q(tm, pairs)
    assert got.shape == (NC, *HW)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    want = np.asarray(jft.multi_step_predict(jm.apply, params, pairs[0][0], 2, n_channels=NC))
    got = tft.multi_step_predict(tm, pairs[0][0], 2, n_channels=NC).numpy()
    assert got.shape == (2, 1, NC, *HW)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_metrics_recorder_matches_jax():
    names = ["MSE", "RMSE", "MAE", "WRMSE", "NWRMSE", "Bias", "TBias", "Activity",
             "WACC", "SWACC", "Anomaly"]
    pred, gt, clim = (rand((2, NC, *HW), 50 + i) for i in range(3))
    std = np.linspace(1.0, 3.0, NC).astype(np.float32)
    data = {"pred": pred, "gt": gt, "clim_mean": clim, "std": std}
    want = jmetrics.MetricsRecorder(names).evaluate_batch(data)
    got = tmetrics.MetricsRecorder(names).evaluate_batch(
        {**data, "pred": torch.from_numpy(pred)})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    with pytest.raises(NotImplementedError):
        tmetrics.MetricsRecorder(["XWRMSE"])


def _small_run(tm, **kw):
    rng = np.random.default_rng(9)
    tr = [(rng.standard_normal((1, NC, *HW), dtype=np.float32),
           [rng.standard_normal((1, NC, *HW), dtype=np.float32)]) for _ in range(2)]
    va = [(rng.standard_normal((1, NC, *HW), dtype=np.float32),
           [rng.standard_normal((1, NC, *HW), dtype=np.float32)])]
    return tft.train_forecast(tm, lambda e: iter(tr), lambda: iter(va),
                              loss_type="Possloss", lr=1e-3, out_shape=(2 * NC, *HW), **kw)


def test_checkpoint_round_trip(tmp_path):
    cfg = CONFIGS["relbias"]
    _, _, tm = model_pair(cfg)
    trainable, _ = _small_run(tm, epochs=1, ckpt_dir=str(tmp_path))
    saved = _port_trainable(trainable)
    _, _, fresh = model_pair(cfg, seed=2)
    init_fn, _ = tft.make_forecast_train_step(fresh, "Possloss", lr=1e-3, total_steps=2,
                                              out_shape=(2 * NC, *HW))
    t2, o2 = init_fn()
    got = tckpt.restore_train_state(str(tmp_path), t2, o2)
    assert got is not None and got[2]["epoch"] == 0 and got[2]["step"] == 2
    restored = _port_trainable(got[0])
    assert sorted(restored) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    assert o2.optimizer.state_dict()["state"][0]["step"] == 2
    assert tckpt.restore_train_state(str(tmp_path / "none"), t2, o2) is None


def test_resume_reproduces_the_loss_trajectory(tmp_path):
    """Stop after epoch 0's checkpoint, restart from checkpoint_latest: the
    resumed epoch repeats the uninterrupted run's losses (the CPU is
    deterministic, so to round-off), best and latest aliases exist, and a
    finished run resumes to train nothing."""
    cfg = CONFIGS["relbias"]
    logs = []
    kw = dict(recorder=tmetrics.MetricsRecorder(["MSE", "WRMSE"]), logger=logs.append)
    _, hist_full = _small_run(model_pair(cfg)[2], epochs=2, **kw)
    d = str(tmp_path / "ck")
    _small_run(model_pair(cfg)[2], epochs=1, ckpt_dir=d, **kw)
    _, hist_resumed = _small_run(model_pair(cfg)[2], epochs=2, ckpt_dir=d, **kw)
    np.testing.assert_allclose(hist_resumed, hist_full[2:], rtol=1e-6)
    assert tckpt.exists(d + "/checkpoint_latest") and tckpt.exists(d + "/checkpoint_best")
    assert any("val:" in line and "WRMSE11" in line for line in logs)
    assert any(line.startswith("resumed at epoch 1 step 2") for line in logs)
    _, hist_again = _small_run(model_pair(cfg)[2], epochs=2, ckpt_dir=d, **kw)
    assert hist_again == []


def test_cli_trains_resumes_and_evaluates_on_cpu(tmp_path):
    from vaevar_tpu_torch import run_train_forecast

    out = str(tmp_path / "cli")
    argv = ["--device", "cpu", "--micro", "--grid", "32x64", "--batch_size", "2",
            "--steps", "2", "--end_time", "2022-01-04 00:00:00", "--out_dir", out,
            "--log_every", "1"]
    _, hist = run_train_forecast.main(argv)
    assert len(hist) == 2 and np.isfinite(hist).all()
    with open(out + "/checkpoint_latest.meta.json") as f:
        assert json.load(f) == {"epoch": 0, "step": 2, "metric_best": pytest.approx(
            json.load(open(out + "/checkpoint_best.meta.json"))["metric_best"])}
    _, hist2 = run_train_forecast.main(argv + ["--epochs", "2"])
    assert len(hist2) == 2
    with open(out + "/checkpoint_latest.meta.json") as f:
        assert json.load(f)["step"] == 4
    with open(out + "/scalars.jsonl") as f:
        steps = [r["step"] for r in map(json.loads, f) if r["tag"] == "loss"]
    assert steps == [0, 1, 2, 3]
    run_train_forecast.main(argv + ["--task", "calculate_q", "--model_ckpt",
                                    out + "/params_latest"])
    q = np.load(out + "/new_q.npy")
    assert q.shape == (1, 69) and (q > 0).all()
    run_train_forecast.main(argv + ["--task", "eval_rollout"])


@pytest.mark.parametrize("flag", ["--mesh", "--data_dir"])
def test_cli_refuses_what_is_not_ported(flag, tmp_path):
    """Every --mesh is ported: DP and DPx1x1 (tests/test_torch_dp.py) and
    the spatial DPxSHxSW (tests/test_torch_spatial_forecast.py), so a
    spatial mesh outside a launch of its processes reaches the launch check
    and raises it, not a refusal; --data_dir is (A.11a): a store without the
    run's frames fails loudly instead of falling back to the synthetic
    source."""
    from vaevar_tpu_torch import run_train_forecast

    if flag == "--mesh":
        with pytest.raises(RuntimeError, match="--mesh 2x2x2 needs 8 processes"):
            run_train_forecast.main(["--device", "cpu", flag, "2x2x2"])
        return
    with pytest.raises(FileNotFoundError, match="2022-01-01_00.npy"):
        run_train_forecast.main(["--device", "cpu", "--micro", "--grid", "32x64",
                                 "--task", "eval_rollout", "--steps", "1",
                                 "--out_dir", str(tmp_path / "out"),
                                 flag, str(tmp_path / "empty")])
