"""The port's optimizer, schedule and LoRA factories against the JAX
package's (optax).

- Each of the 8 optimizers (and SGD and RMSprop with momentum): the
  parameter displacement after 5 updates of the same model on the same data
  within rtol 1e-4, a few f32 ulp of the per-step update; at |w| ~ 20 a
  missing 0.1 accumulator (Adagrad), eps outside the square root (Adagrad,
  RMSprop) or outside the infinity norm (Adamax) moves the displacement by
  more.
- The three schedules, with warmup: the rate at steps 0..T+2 within rel
  1e-6, read from the optimizer after each step, with an absolute floor of
  4 f32 ulp of 1 times the base rate: optax evaluates the cosine factor in
  f32, and near the end of the decay 1 + cos cancels (observed 2.3e-11 at
  a rate of 1.7e-5, rel 1.3e-6; the port computes in f64).
- The LoRA mask selects only LoRA parameters, and the finetune optimizer
  (SGD, and AdamW with its decay) moves every one of them and leaves every
  other parameter bitwise unchanged. The weights are N(0, 0.3^2): under
  0.02 the LoRA gradients are 1e-19 to 1e-12, steps lost in the weights'
  rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import rand
from vaevar_tpu import config as C
from vaevar_tpu.train import builder as jb
from vaevar_tpu_torch.models.lgunet import LGUnet
from vaevar_tpu_torch.train import builder as tb
from vaevar_tpu_torch.utils.fast_init import fast_init

torch.set_num_threads(1)

SHAPE, STEPS = (3, 4, 8), 5
OPTIMIZERS = [("SGD", {}), ("SGD", {"momentum": 0.9, "nesterov": True}), ("ASGD", {}),
              ("Adagrad", {}), ("Adamax", {}), ("Adadelta", {}), ("Adam", {}),
              ("AdamW", {"weight_decay": 0.1}), ("RMSprop", {}),
              ("RMSprop", {"momentum": 0.9})]


def _loss_np():
    return rand(SHAPE, 1) + 20.0, rand(SHAPE, 2), rand(SHAPE, 3) + 1.0


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_optimizer_matches_optax(name, kw):
    w0, t, x = _loss_np()
    lr = 1e-2 if name != "Adadelta" else 1.0  # Adadelta's lr is a plain scale

    def jloss(p):
        return jnp.mean(((p["w"] - t) * x) ** 2)

    opt = jb.make_optimizer(name, lr=lr, **kw)
    params = {"w": jnp.asarray(w0)}
    state = opt.init(params)
    for _ in range(STEPS):
        upd, state = opt.update(jax.grad(jloss)(params), state, params)
        params = optax.apply_updates(params, upd)
    want = np.asarray(params["w"]) - w0

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = tb.make_optimizer([w], name, lr=lr, **kw)
    tt, tx = torch.from_numpy(t), torch.from_numpy(x)
    for _ in range(STEPS):
        topt.zero_grad()
        torch.mean(((w - tt) * tx) ** 2).backward()
        topt.step()
    got = w.detach().numpy() - w0
    assert np.abs(want).min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError):
        tb.make_optimizer([torch.nn.Parameter(torch.ones(2))], "LBFGS")


@pytest.mark.parametrize("spec", [
    {"sched": "cosine", "warmup_steps": 3, "min_lr": 1e-5},
    {"sched": "cosine"},
    {"sched": "step", "decay_steps": 4, "decay_rate": 0.5, "warmup_epochs": 2, "min_lr": 2e-4},
    {"sched": "step"},
    {"sched": "constant", "warmup_steps": 2},
])
def test_schedule_matches_optax(spec):
    base, T = 1e-3, 12
    floor = 4 * 2.0 ** -24 * base
    want = jb.make_schedule(spec, base, T)
    sched = tb.make_schedule(spec, base, T)
    p = torch.nn.Parameter(torch.ones(2))
    opt = tb.make_optimizer([p], "SGD", lr=base)
    lr_sched = tb.ScheduleLR(opt, sched)
    for s in range(T + 3):
        assert sched(s) == pytest.approx(float(want(s)), rel=1e-6, abs=floor), s
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(s)), rel=1e-6,
                                                          abs=floor), s
        opt.step()
        lr_sched.step()


def test_unknown_schedule_raises():
    with pytest.raises(NotImplementedError):
        tb.make_schedule({"sched": "poly"}, 1.0, 10)


def _lora_model():
    cfg = C.micro_config(attn_type="relbias", lora_rank=2, inchans_list=(4, 13),
                         outchans_list=(8, 26))
    return fast_init(LGUnet(cfg), seed=4, scale=0.3)


def test_lora_mask_selects_only_lora():
    model = _lora_model()
    mask = tb.lora_mask(model)
    assert sorted(mask) == sorted(n for n, _ in model.named_parameters())
    lora = [n for n, on in mask.items() if on]
    assert lora and all(n.rsplit(".", 2)[-2] in ("qA", "qB") for n in lora)
    assert all(not on for n, on in mask.items() if ".qA." not in n and ".qB." not in n)


@pytest.mark.parametrize("name", ["SGD", "AdamW"])
def test_finetune_optimizer_freezes_the_backbone(name):
    model = _lora_model()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = tb.finetune_optimizer(model, name, lr=0.5, weight_decay=0.1)
    x = torch.from_numpy(rand((1, 17, 16, 32), 5))
    for _ in range(2):
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
    mask = tb.lora_mask(model)
    moved = {n: not torch.equal(p, before[n]) for n, p in model.named_parameters()}
    assert all(moved[n] == mask[n] for n in moved), \
        [n for n in moved if moved[n] != mask[n]]
    with pytest.raises(ValueError, match="no LoRA"):
        tb.finetune_optimizer(fast_init(LGUnet(C.micro_config()), seed=1))
