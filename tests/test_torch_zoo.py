"""The port's layer zoo and MoE ops against the JAX package's.

Each module of vaevar_tpu/models/zoo.py is built in both packages with the
same random weights (every parameter drawn, so that biases and ConvNeXt's
layer scale, zero or 1e-6 at init, take part), carried over by
utils/port_jax.py::zoo_state_dict_from_flax, and run on the same numpy
inputs; then the invariants of tests/test_zoo.py are run on the port.

Tolerances, with the reason:
- module outputs: rtol 1e-4, atol 1e-5 (f32; matmuls, layer norms and
  pooling summed in another order, a few ulp per layer, outputs O(1)).
- parameter and input gradients of sum(y * g) (+ the MoE losses): rtol
  1e-3, atol 1e-5 x the largest |gradient| of the module (the forward's
  round-off through the backward; the tiniest entries against the floor).
- MoE losses and ops: rtol 1e-6 (the same f32 reductions); routing
  indices, capacity masks and the uniform jitter: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rand
from vaevar_tpu.models import zoo as jzoo
from vaevar_tpu.ops import moe as jmoe
from vaevar_tpu_torch.models import zoo
from vaevar_tpu_torch.ops import moe
from vaevar_tpu_torch.ops import posenc
from vaevar_tpu_torch.ops import rope
from vaevar_tpu_torch.utils import jax_random
from vaevar_tpu_torch.utils.port_jax import zoo_state_dict_from_flax

torch.set_num_threads(1)

HW = (8, 16)
X16, X32 = (1, *HW, 16), (1, *HW, 32)
# id: (module name, constructor kwargs, port-only kwargs, input shapes)
CASES = {
    "ScaleOffset": ("ScaleOffset", dict(dim=16), {}, [X16]),
    "SEBlock": ("SEBlock", dict(dim=16), {}, [X16]),
    "RelativePositionalBias": ("RelativePositionalBias", dict(window_size=(2, 4), num_heads=3),
                               {}, [(5, 3, 8, 8)]),
    "CrossAttention": ("CrossAttention", dict(dim=32, window_size=(2, 4), num_heads=4), {},
                       [(2, *HW, 32), (2, *HW, 32)]),
    "ConvAttention": ("ConvAttention", dict(dim=32, window_size=(4, 4), num_heads=2), {}, [X32]),
    "DilatedAttention": ("DilatedAttention", dict(dim=16, window_size=(2, 4), num_heads=2,
                                                  dilated_size=(2, 2)), {}, [X16]),
    "GAUAttention-lin": ("GAUAttention", dict(dim=16, window_size=(4, 4), s=8), {}, [X16]),
    "GAUAttention-quad": ("GAUAttention", dict(dim=16, window_size=(4, 4), s=8,
                                               attn_type="quad"), {}, [X16]),
    "HydraAttention-local": ("HydraAttention", dict(dim=16, window_size=(4, 4), num_heads=2),
                             {}, [X16]),
    "HydraAttention-global": ("HydraAttention", dict(dim=16, window_size=(4, 4), num_heads=2,
                                                     local=False), {}, [X16]),
    "HydraAttention-hydra": ("HydraAttention", dict(dim=16, window_size=(4, 4), num_heads=2,
                                                    use_attn=False), {}, [X16]),
    "HiLoAttention": ("HiLoAttention", dict(dim=32, num_heads=4, window_size=(2, 2),
                                            alpha=0.5), {}, [X32]),
    "HiLoAttention-hifi": ("HiLoAttention", dict(dim=32, num_heads=4, window_size=(2, 2),
                                                 alpha=0.0), {}, [X32]),
    "HiLoAttention-lofi": ("HiLoAttention", dict(dim=32, num_heads=4, window_size=(1, 1),
                                                 alpha=0.5), {}, [X32]),
    "MoEDense-drop-straight-through": ("MoEDense", dict(
        features=16, num_experts=3, attr_dim=16, expert_capacity=0.5, is_scale_prob=False),
        {}, [X16]),
    "MoEDense-attr-widen": ("MoEDense", dict(features=24, num_experts=4, attr_dim=16,
                                             drop_tokens=False), {}, [X16, X16]),
    "MoEMlp": ("MoEMlp", dict(dim=16, hidden=32, num_experts=2), {}, [X16]),
    "MoEWindowAttention": ("MoEWindowAttention", dict(dim=16, window_size=(4, 4), num_heads=2,
                                                      num_experts=3, shift_size=(2, 2)), {},
                           [X16]),
    "GluMlp": ("GluMlp", dict(dim=16, hidden=32), {}, [X16]),
    "GatedMlp": ("GatedMlp", dict(dim=16), dict(resolution=HW), [X16]),
    "GatedMlp-weight": ("GatedMlp", dict(dim=16, get_weight=True), dict(resolution=HW), [X16]),
    "ConvMlp": ("ConvMlp", dict(dim=16, hidden=32), {}, [X16]),
    "MAGMlp": ("MAGMlp", dict(dim=16, window_size=(4, 8)), {}, [X16]),
    "RCAB": ("RCAB", dict(dim=16), {}, [X16]),
    "RDCAB": ("RDCAB", dict(dim=16), {}, [X16]),
    "DWMlp": ("DWMlp", dict(dim=16, hidden=32), {}, [X16]),
    "ConvNeXtBlock": ("ConvNeXtBlock", dict(dim=24, kernel_size=(4, 8), groups=12), {},
                      [(1, *HW, 24)]),
    "HiLoBlock": ("HiLoBlock", dict(dim=16, window_size=(2, 2), num_heads=2, alpha=0.5), {},
                  [X16]),
    "HiLoBlock-post-norm": ("HiLoBlock", dict(dim=16, window_size=(2, 2), num_heads=2,
                                              alpha=0.5, pre_norm=False), {}, [X16]),
    "ConvFFNBlock": ("ConvFFNBlock", dict(dim=16), {}, [X16]),
    "MoEWindowBlock": ("MoEWindowBlock", dict(dim=16, window_size=(4, 4), num_heads=2,
                                              num_experts=2, shift_size=(2, 2)), {}, [X16]),
    "ViTAttention": ("ViTAttention", dict(dim=16, num_heads=4), {}, [(2, 10, 16)]),
    "ViTCrossAttention": ("ViTCrossAttention", dict(dim=16, num_heads=4), {},
                          [(2, 10, 16), (2, 7, 16)]),
    "ViTBlock": ("ViTBlock", dict(dim=16, num_heads=4), {}, [(2, 10, 16)]),
    "ViTDecoderBlock": ("ViTDecoderBlock", dict(dim=16, num_heads=4), {},
                        [(2, 10, 16), (2, 7, 16)]),
}


def _flat(out):
    """A module's output as (y, [scalar losses])."""
    if not isinstance(out, tuple):
        return out, []
    y, *rest = out
    return y, [t for r in rest for t in (r if isinstance(r, tuple) else (r,))]


def _module_pair(case):
    """(JAX module, its params, the port module with the same weights,
    inputs). The flax tree's shapes come from eval_shape (an eager flax init
    costs seconds); every leaf is N(0, 0.1^2), LayerNorm scales 1 + N(0,
    0.1^2)."""
    name, kw, extra, shapes = CASES[case]
    xs = [rand(s, 10 + i) for i, s in enumerate(shapes)]
    jm = getattr(jzoo, name)(**kw)
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *xs)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    params = jax.tree_util.tree_unflatten(treedef, [
        float(path[-1].key == "scale") + rand(leaf.shape, 3 + i, 0.1)
        for i, (path, leaf) in enumerate(leaves)])
    tm = getattr(zoo, name)(**kw, **extra)
    tm.load_state_dict(zoo_state_dict_from_flax(params), strict=True)
    return jm, params, tm, xs


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_jax(case):
    jm, params, tm, xs = _module_pair(case)
    xt = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    y_t, extra_t = _flat(tm(*xt))
    g = rand(tuple(y_t.shape), 4)
    ((y_t * torch.from_numpy(g)).sum() + sum(extra_t)).backward()

    def loss(p, *args):
        y, extra = _flat(jm.apply(p, *args))
        return jnp.sum(y * g) + sum(extra), (y, extra)

    (_, (y_j, extra_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, *map(jnp.asarray, xs))

    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)
    for a, b in zip(extra_t, extra_j):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    want = {k: v.numpy() for k, v in zoo_state_dict_from_flax(gp_j).items()}
    want["input"] = np.asarray(gx_j)
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    got["input"] = xt[0].grad.numpy()
    assert sorted(got) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5 * scale, err_msg=k)


def test_every_public_zoo_and_moe_name_is_ported():
    names = {n for n in dir(jzoo) if not n.startswith("_")
             and getattr(getattr(jzoo, n), "__module__", None) == jzoo.__name__}
    names.add("_WindowCore")
    assert {n for n in names if not hasattr(zoo, n)} == set()
    covered = {c[0] for c in CASES.values()} | {"periodic_pad2d", "attn_norm", "_WindowCore"}
    assert names - covered == set()
    ops = {n for n in dir(jmoe) if not n.startswith("_")
           and getattr(getattr(jmoe, n), "__module__", None) == jmoe.__name__}
    assert ops == {"router_z_loss", "load_balancing_loss", "top1_route", "capacity_mask",
                   "moe_combine"}
    assert all(callable(getattr(moe, n)) for n in ops)


def test_window_core_and_functions_match_jax():
    """_WindowCore (parameter-free) on a shifted qkv, periodic_pad2d and
    the three attn_norm methods (with -inf entries)."""
    qkv = rand((1, *HW, 48), 5)
    for shift in ((0, 0), (2, 0), (2, 2)):
        want = jzoo._WindowCore((4, 4), 2).apply({}, jnp.asarray(qkv), shift, HW)
        got = zoo._WindowCore((4, 4), 2)(torch.from_numpy(qkv), shift, HW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    x = rand((1, 4, 8, 2), 6)
    np.testing.assert_array_equal(zoo.periodic_pad2d(torch.from_numpy(x), (1, 2)).numpy(),
                                  np.asarray(jzoo.periodic_pad2d(jnp.asarray(x), (1, 2))))
    logits = rand((3, 4, 9), 7)
    logits[0, 0, :4] = -np.inf
    for method in ("softmax", "squared_relu", "softmax_plus"):
        np.testing.assert_allclose(zoo.attn_norm(torch.from_numpy(logits), method).numpy(),
                                   np.asarray(jzoo.attn_norm(jnp.asarray(logits), method)),
                                   rtol=1e-6, atol=1e-7, err_msg=method)


# --- MoE ops -------------------------------------------------------------------


def test_router_losses_match_jax():
    logits = rand((2, 40, 4), 1, 3.0)
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    idx = jnp.argmax(probs, -1)
    np.testing.assert_allclose(moe.router_z_loss(torch.from_numpy(logits)).item(),
                               float(jmoe.router_z_loss(jnp.asarray(logits))), rtol=1e-6)
    got = moe.load_balancing_loss(torch.from_numpy(np.array(probs)),
                                  torch.from_numpy(np.array(idx)), 4)
    np.testing.assert_allclose(got.item(), float(jmoe.load_balancing_loss(probs, idx, 4)),
                               rtol=1e-6)


@pytest.mark.parametrize("cf, n_tokens, n_experts", [(0.5, 40, 4), (0.7, 10, 7), (1.0, 64, 4),
                                                     (1.25, 33, 3), (2.0, 16, 8)])
def test_capacity_mask_matches_jax(cf, n_tokens, n_experts):
    """Position by cumsum in token order, capacity floor(cf * T / E) taken in
    f32 (0.7 * 10 / 7 is 1 in f32 and 0.999... in f64)."""
    idx = np.random.default_rng(n_tokens).integers(0, n_experts, n_tokens)
    for drop in (True, False):
        got = moe.capacity_mask(torch.from_numpy(idx), n_experts, cf, drop).numpy()
        want = np.asarray(jmoe.capacity_mask(jnp.asarray(idx), n_experts, cf, drop))
        np.testing.assert_array_equal(got, want)
    if cf < 1:
        assert got.sum() > moe.capacity_mask(torch.from_numpy(idx), n_experts, cf).sum()


@pytest.mark.parametrize("is_scale_prob", [True, False])
@pytest.mark.parametrize("d_out", [6, 9])
def test_moe_combine_and_straight_through_gradient_match_jax(is_scale_prob, d_out):
    """The combine, the passthrough of dropped tokens (d_in == d_out only),
    and the gradients to the expert outputs, the token stream and the router
    prob: p scales every token, or p / stop_gradient(p) is 1 with p's
    gradient."""
    E, T, d_in = 3, 12, 6
    outs, x, p = rand((E, T, d_out), 1), rand((T, d_in), 2), np.abs(rand((T,), 3)) + 0.2
    idx = np.random.default_rng(4).integers(0, E, T)
    mask = np.array(jmoe.capacity_mask(jnp.asarray(idx), E, 0.5))
    g = rand((T, d_out), 5)

    def jloss(o, xx, pp):
        return jnp.sum(jmoe.moe_combine(o, jnp.asarray(mask), pp, xx, is_scale_prob) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (outs, x, p)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (outs, x, p)]
    y = moe.moe_combine(ts[0], torch.from_numpy(mask), ts[2], ts[1], is_scale_prob)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jmoe.moe_combine(*map(jnp.asarray, (outs, mask, p, x)), is_scale_prob)),
        rtol=1e-6, atol=1e-7)
    (y * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):  # x takes no part when d_in != d_out
        got = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6, atol=1e-6)


def test_uniform_replays_jax():
    key = jax.random.PRNGKey(11)
    for shape, lo, hi in (((3, 50, 7), 0.99, 1.01), ((1000,), -2.0, 3.5), ((4, 4), 0.0, 1.0)):
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(jax_random.uniform(jax_random.prng_key(11), shape, lo, hi)
                                      .numpy(), want)


def test_top1_route_matches_jax_with_its_jitter_and_ties():
    """The router on jittered attr with JAX's noise (the same key), then
    argmax's first maximum on tied probabilities."""
    attr = rand((2, 30, 8), 1)
    w, b = rand((8, 4), 2), rand((4,), 3)
    key = jax.random.PRNGKey(5)
    for rng_j, rng_t in ((None, None), (key, jax_random.prng_key(5))):
        idx_j, probs_j, logits_j = jmoe.top1_route(jnp.asarray(attr), lambda a: a @ w + b,
                                                   rng_j, 0.3)
        idx_t, probs_t, logits_t = moe.top1_route(
            torch.from_numpy(attr), lambda a: a @ torch.from_numpy(w) + torch.from_numpy(b),
            rng_t, 0.3)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    gen = torch.Generator().manual_seed(0)
    jittered = moe.top1_route(torch.from_numpy(attr), lambda a: a, gen, 0.3)[2]
    ratio = jittered.numpy() / attr
    assert 0.7 <= ratio.min() and ratio.max() < 1.3 and ratio.std() > 0.05
    ties = np.array([[0.0, 1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 0.0, 3.0]],
                    np.float32)
    idx_t = moe.top1_route(torch.from_numpy(ties), lambda a: a)[0]
    np.testing.assert_array_equal(
        idx_t.numpy(), np.asarray(jmoe.top1_route(jnp.asarray(ties), lambda a: a)[0]))


# --- tests/test_zoo.py's invariants on the port --------------------------------


def _x(shape, seed=0):
    return torch.from_numpy(rand(shape, seed))


def test_posenc_and_rope3_invariants():
    assert posenc.positional_encoding_1d(10, 6).shape == (10, 6)
    assert posenc.positional_encoding_2d(4, 8, 10).shape == (4, 8, 10)
    assert posenc.positional_encoding_3d(2, 4, 8, 12).shape == (2, 4, 8, 12)
    e = posenc.positional_encoding_2d(8, 16, 16)
    assert np.abs(e).max() <= 1.0 + 1e-6 and not np.allclose(e[0, 0], e[3, 7])
    e = posenc.build_2d_sincos_posemb(4, 8, 64)
    assert e.shape == (1, 32, 64)
    np.testing.assert_allclose(e[0, :, :16] ** 2 + e[0, :, 16:32] ** 2, 1.0, atol=1e-5)
    idx = posenc.relative_position_index((3, 5))
    assert idx.shape == (15, 15) and len(set(np.diag(idx))) == 1 and idx.max() < 5 * 9
    shape, d = (2, 3, 4), 12
    tables = [torch.from_numpy(t) for t in rope.rope3_tables(shape, d)]
    x = _x((5, 24, d))
    y = rope.apply_rope3(x, tables)
    np.testing.assert_allclose(y.norm(dim=-1).numpy(), x.norm(dim=-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(y[:, 0].numpy(), x[:, 0].numpy(), atol=1e-6)


def test_moe_op_invariants():
    logits = _x((2, 10, 4))
    expected = np.mean(np.log(np.exp(logits.numpy()).sum(-1)) ** 2)
    assert abs(moe.router_z_loss(logits).item() - expected) < 1e-5
    E, T = 4, 64
    uniform = moe.load_balancing_loss(torch.full((T, E), 1.0 / E), torch.arange(T) % E, E)
    assert abs(uniform.item() - 1.0) < 1e-5
    idx = torch.zeros(8, dtype=torch.int64)  # all tokens to expert 0, capacity 2
    assert moe.capacity_mask(idx, 4, 1.0)[:, 0].sum().item() == 2.0
    assert moe.capacity_mask(idx, 4, 1.0, drop_tokens=False)[:, 0].sum().item() == 8.0
    x = _x((4, 3))
    y = moe.moe_combine(torch.zeros(2, 4, 3), torch.zeros(4, 2), torch.full((4,), 0.7), x)
    np.testing.assert_allclose(y.numpy(), 0.7 * x.numpy(), atol=1e-6)


def test_module_invariants():
    torch.manual_seed(0)
    with torch.no_grad():
        m = zoo.GluMlp(8, 16)
        x = _x((2, 5, 8))
        h = x @ m.fc1.weight.T + m.fc1.bias
        want = (h[..., :8] * torch.sigmoid(h[..., 8:])) @ m.fc2.weight.T + m.fc2.bias
        np.testing.assert_allclose(m(x).numpy(), want.numpy(), atol=1e-5)
        x = _x((1, *HW, 24))  # layer scale 1e-6: the block is near the identity
        np.testing.assert_allclose(zoo.ConvNeXtBlock(24, (4, 8), 12)(x).numpy(), x.numpy(),
                                   atol=1e-3)
        for cls, kw in ((zoo.GatedMlp, dict(dim=16, resolution=HW)), (zoo.MAGMlp, dict(dim=16)),
                        (zoo.RCAB, dict(dim=16)), (zoo.RDCAB, dict(dim=16)),
                        (zoo.ConvMlp, dict(dim=16, hidden=32)),
                        (zoo.DWMlp, dict(dim=16, hidden=32)), (zoo.ConvFFNBlock, dict(dim=16)),
                        (zoo.HiLoBlock, dict(dim=16, window_size=(2, 2), num_heads=2,
                                             alpha=0.5))):
            y = cls(**kw)(_x(X16))
            assert y.shape == X16 and bool(torch.isfinite(y).all()), cls.__name__
        for alpha, ws in ((0.5, (2, 2)), (0.0, (2, 2)), (0.5, (1, 1))):
            assert zoo.HiLoAttention(32, 4, ws, alpha)(_x(X32)).shape == X32
        y, zs, bs = zoo.MoEWindowBlock(16, (4, 4), 2, num_experts=2, shift_size=(2, 2))(_x(X16))
        assert y.shape == X16 and len(zs) == 2 and len(bs) == 2
        x, ctx = _x((2, 10, 16)), _x((2, 7, 16), 3)
        assert zoo.ViTBlock(16, 4)(x).shape == x.shape
        assert zoo.ViTDecoderBlock(16, 4)(x, ctx).shape == x.shape
        x = _x((1, 4, 8, 2))
        y = zoo.periodic_pad2d(x, (1, 2))
        assert y.shape == (1, 6, 12, 2) and y[:, 0].abs().sum().item() == 0.0
        np.testing.assert_array_equal(y[:, 1:-1, :2].numpy(), x[:, :, -2:].numpy())
