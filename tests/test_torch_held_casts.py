"""A frozen LGUnet's held weight copies (vaevar_tpu_torch/models/lgunet.py::
held): the bf16 casts of `dense`, the patch embed and the conv-transpose
heads, and the relbias blocks' gathered bias, made once where a parameter
does not require grad.

On micro bf16 relbias and rope LGUnets (block remat on, so that the
backward's recompute takes the copies too), against a twin that casts and
gathers at every call (`held` patched to make its copy each time, the code
before held copies):
- the forward, the gradient with respect to the input and a torch.func.jvp
  are bitwise the twin's; the first call makes one copy per cast or
  gathered parameter and later calls make none; a first call inside a jvp
  makes plain copies that outlive it;
- a model whose parameters require grad takes no held copy and its
  parameter gradients are the twin's;
- after `load_state_dict` of new weights, after `.to(torch.float64)` and
  back, and after an in-place write, the next forward is a fresh model's,
  and `lgunet.cast_made` counts the copies remade; `refresh_held` remakes
  them in place (the same tensors), or drops one whose parameter changed
  shape;
- a copy first asked for inside a capture raises; the state dict,
  parameters and buffers are as without copies, and a deep copy starts
  without them.
"""

import copy

import pytest
import torch

from vaevar_tpu_torch import config as cfgs
from vaevar_tpu_torch.models import lgunet
from vaevar_tpu_torch.models.lgunet import LGUnet, refresh_held
from vaevar_tpu_torch.utils import capture, trace

torch.set_num_threads(1)
ATTN = ("relbias", "rope")
HW = (16, 32)
KEYS = ("lgunet.cast_held", "lgunet.cast_made")


def _model(attn, seed=0, frozen=True):
    torch.manual_seed(seed)
    cfg = cfgs.micro_config(img_size=HW, attn_type=attn, enc_depths=(2, 1), lg_depths=(2,),
                            dtype=torch.bfloat16, remat=True)
    return LGUnet(cfg).requires_grad_(not frozen)


def _x(seed=1):
    return torch.randn((1, 69, *HW), generator=torch.Generator().manual_seed(seed))


def _n_held(model):
    """The copies the model's parameters need: each cast to bf16 (every
    f32 weight and bias of `dense`, the patch embeds and heads, but the f32
    PatchMerging/PatchExpand ones) and each relbias table."""
    return sum(len(m.__dict__.get("_held", {})) for m in model.modules())


def _added(before):
    after = trace.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in KEYS}


@pytest.fixture
def per_call(monkeypatch):
    """The twin: `held` makes its copy at every call, as the casts and the
    gather ran before held copies."""
    def patch():
        monkeypatch.setattr(lgunet, "held", lambda module, name, key, make: make(
            getattr(module, name)))
    return patch


def _forward_grad_jvp(model, x, u):
    y = model(x)
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((model(xg) * u).sum(), xg)
    _, t = torch.func.jvp(model, (x,), (x.flip(-1),))
    return y, g, t


@pytest.mark.parametrize("attn", ATTN)
def test_frozen_model_is_bitwise_the_per_call_twin(attn, per_call):
    model, x = _model(attn), _x()
    u = torch.randn((1, 138, *HW), generator=torch.Generator().manual_seed(2))
    before = trace.counters()
    got = _forward_grad_jvp(model, x, u)
    added = _added(before)
    n = _n_held(model)
    assert n > 0 and added["lgunet.cast_made"] == n
    before = trace.counters()
    again = _forward_grad_jvp(model, x, u)
    steady = _added(before)
    assert steady["lgunet.cast_made"] == 0 and steady["lgunet.cast_held"] > n
    per_call()
    before = trace.counters()
    want = _forward_grad_jvp(model, x, u)
    assert _added(before) == {k: 0 for k in KEYS}
    for a, b, c in zip(got, again, want, strict=True):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("attn", ATTN)
def test_trainable_model_takes_no_held_copy(attn, per_call):
    x, u = _x(), torch.randn((1, 138, *HW), generator=torch.Generator().manual_seed(3))

    def grads():
        model = _model(attn, frozen=False)
        y = model(x)
        (y * u).sum().backward()
        return model, y, [p.grad for p in model.parameters()]

    before = trace.counters()
    model, y, g = grads()
    assert _added(before) == {k: 0 for k in KEYS} and _n_held(model) == 0
    per_call()
    _, y_twin, g_twin = grads()
    assert torch.equal(y, y_twin)
    assert all(a is not None and torch.equal(a, b) for a, b in zip(g, g_twin, strict=True))


def _fresh_forward(attn, state):
    fresh = _model(attn)
    fresh.load_state_dict(state)
    return fresh(_x())


@pytest.mark.parametrize("attn", ATTN)
def test_copies_follow_the_weights(attn):
    model = _model(attn)
    model(_x())
    n = _n_held(model)
    copies = {id(e.copy) for m in model.modules() for e in m.__dict__.get("_held", {}).values()}

    # new weights loaded in place: every copy remade at the next call
    new = _model(attn, seed=5).state_dict()
    model.load_state_dict(new)
    before = trace.counters()
    y = model(_x())
    assert _added(before)["lgunet.cast_made"] == n
    assert torch.equal(y, _fresh_forward(attn, new))

    # another storage and back: remade again, the same values
    model.to(torch.float64).to(torch.float32)
    before = trace.counters()
    assert torch.equal(model(_x()), y)
    assert _added(before)["lgunet.cast_made"] == n

    # an in-place write to one weight: its copy alone
    w = model.net.layers[0].blocks[0].mlp.fc1.weight
    with torch.no_grad():
        w.mul_(2)
    before = trace.counters()
    y2 = model(_x())
    assert _added(before)["lgunet.cast_made"] == 1
    assert torch.equal(y2, _fresh_forward(attn, model.state_dict()))
    assert not torch.equal(y2, y)
    held_now = {id(e.copy) for m in model.modules()
                for e in m.__dict__.get("_held", {}).values()}
    assert held_now == copies  # every remake went into the tensor it replaced


@pytest.mark.parametrize("attn", ATTN)
def test_refresh_held_remakes_in_place_or_drops(attn):
    model = _model(attn)
    model(_x())
    n = _n_held(model)
    fc1 = model.net.layers[0].blocks[0].mlp.fc1
    entry = fc1._held[("weight", torch.bfloat16)]
    kept = entry.copy
    before = trace.counters()
    assert refresh_held(model)  # nothing changed: nothing made
    model.load_state_dict(_model(attn, seed=6).state_dict())
    assert refresh_held(model)
    assert _added(before)["lgunet.cast_made"] == n
    assert fc1._held[("weight", torch.bfloat16)].copy is kept
    assert torch.equal(kept, fc1.weight.to(torch.bfloat16))
    before = trace.counters()
    model(_x())
    assert _added(before)["lgunet.cast_made"] == 0
    # a parameter of another shape: its copy cannot be remade in place
    fc1.weight.data = torch.zeros(fc1.out_features, fc1.in_features + 1)
    assert not refresh_held(model)
    assert ("weight", torch.bfloat16) not in fc1._held and _n_held(model) == n - 1


def test_first_copy_inside_a_capture_raises(monkeypatch):
    model, x = _model("relbias"), _x()
    monkeypatch.setattr(capture, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        model(x)
    monkeypatch.undo()
    want = model(x)  # the warm-up makes them
    monkeypatch.setattr(capture, "capturing", lambda: True)
    with trace.tallied() as tally:
        got = model(x)
    assert torch.equal(got, want)
    assert tally.counts.get("lgunet.cast_made", 0) == 0 and tally.counts["lgunet.cast_held"] > 0


def test_copies_are_not_state():
    model = _model("relbias")
    keys = list(model.state_dict())
    params = [(n, p.data_ptr()) for n, p in model.named_parameters()]
    buffers = [(n, b.data_ptr()) for n, b in model.named_buffers()]
    y = model(_x())
    assert _n_held(model) > 0
    assert list(model.state_dict()) == keys
    assert [(n, p.data_ptr()) for n, p in model.named_parameters()] == params
    assert [(n, b.data_ptr()) for n, b in model.named_buffers()] == buffers
    twin = copy.deepcopy(model)
    assert _n_held(twin) == 0
    before = trace.counters()
    assert torch.equal(twin(_x()), y)
    assert _added(before)["lgunet.cast_made"] == _n_held(model)


def test_first_copy_inside_a_jvp_outlives_it(per_call):
    """A frozen model's first call inside torch.func.jvp (a jvp probe's)
    makes plain copies, which later calls take as they are."""
    model, x = _model("relbias"), _x()
    _, t = torch.func.jvp(model, (x,), (x.flip(-1),))
    copies = [e.copy for m in model.modules() for e in m.__dict__.get("_held", {}).values()]
    assert copies and not any(torch._C._functorch.is_functorch_wrapped_tensor(c)
                              for c in copies)
    before = trace.counters()
    y = model(x)
    assert _added(before)["lgunet.cast_made"] == 0
    per_call()
    assert torch.equal(y, model(x))
    assert torch.equal(t, torch.func.jvp(model, (x,), (x.flip(-1),))[1])
