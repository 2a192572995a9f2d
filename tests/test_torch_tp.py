"""The tensor- and expert-parallel placements (parallel/tensor_parallel.py:
`shard_tensor_parallel`, `tensor_parallel_state_dict`, `shard_experts`)
against the port's single process and the JAX package's placements.

Four gloo ranks in subprocesses on the CPU, one torch thread each (this file
is also the worker: `python tests/test_torch_tp.py <dir>` with torchrun's
environment), place micro LGUnets at tp 2 (`--mesh 2x1x2`: the tp groups
{0, 2} and {1, 3}) and tp 4 (`4x1x1`), and a MoEMlp of 8 experts at ep 2
and 4. While they run, this process computes the same things in one
process, and JAX computes them on its placements ({"tp": N} and {"ep": N}
meshes of its CPU devices).

The models (2 variable groups at 16x32, weights from JAX's fast_init):
- relbias: an LG stage of 2 blocks with 4 heads (split at tp 2 and 4);
- rope: LoRA rank 4, a full-grid LG stage of 2 heads, then a windowed one
  of 4 (at tp 4 the first keeps its attention whole);
- micro: micro_config's LG stage of 1 head (attention whole at any tp, the
  MLP split).

Tolerances:
- the forward against JAX's shard_tensor_parallel and against one process:
  rtol = atol = 2e-5 (tests/test_models.py:66-105);
- the parameter gradients of mean(y^2), gathered to the full keys: rtol
  5e-4, atol 1e-5 (the same test's bounds); the input gradient and the jvp
  slope against one process: rtol 1e-5 (atol 1e-5 x max|grad|);
- tensor_parallel_state_dict of a placed model: the input state dict, bit
  for bit; the ranks' outputs and gathered gradients: bitwise equal;
- two forecast AdamW steps (LpLoss, lr 1e-3) of a tp 2 model against one
  process: losses rel 1e-5, parameters rtol 5e-4, atol 5e-6
  (tests/test_training.py:177-235's bounds);
- shard_experts: output rtol 2e-6, atol 1e-6, the z and balance losses
  rtol 1e-6, gradients rtol 5e-5, atol 1e-6 (tests/test_zoo.py:199-240's
  bounds), against JAX's shard_experts (no router noise) and against the
  port's single process with the same router generator.
JAX's forward and gradients of a placement compile for 15-25 s on one CPU
thread: the fast tier holds the forward of two of the six cases to JAX's
(every case's forward and gradients to one process), the slow tier the
forward and gradients of all six.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
HW = (16, 32)
GROUPS = dict(inchans_list=(4, 13), outchans_list=(8, 26))
NC = 17
TP_MESH = {2: "2x1x2", 4: "4x1x1"}
CASES = [(m, tp) for m in ("relbias", "rope", "micro") for tp in (2, 4)]
JAX_FAST = [("rope", 2), ("relbias", 4)]
SEEDS = {"relbias": 1, "rope": 2, "micro": 3, "train": 4}
EP = (2, 4)
E = 8
MOE_X = (2, 8, 16, 16)


def _configs(C):
    return {
        "relbias": C.micro_config(img_size=HW, attn_type="relbias", embed_dim=32,
                                  lg_depths=(2,), lg_heads=(4,), **GROUPS),
        "rope": C.micro_config(img_size=HW, embed_dim=32, lg_depths=(1, 2), lg_heads=(2, 4),
                               lora_rank=4, **GROUPS),
        "micro": C.micro_config(img_size=HW, **GROUPS),
        "train": C.micro_config(img_size=HW, lg_heads=(2,), **GROUPS),
    }


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# --- the port: one process, or one rank --------------------------------------


def _model(d: Path, name):
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models.lgunet import LGUnet

    m = LGUnet(_configs(tcfg)[name])
    m.load_state_dict(torch.load(d / f"{name}.pt"), strict=True)
    return m


def _fwd_bwd(model, x, u):
    """{y, input gradient, jvp slope} of loss = mean(model(x)^2); the
    parameters' gradients are left in .grad."""
    xg = x.clone().requires_grad_(True)
    y = model(xg)
    torch.mean(y ** 2).backward()
    _, slope = torch.func.jvp(lambda v: torch.mean(model(v) ** 2), (x,), (u,))
    return {"y": y.detach(), "xgrad": xg.grad, "slope": slope.detach()}


def _grads(model, gather=None):
    """The parameters' gradients under the full model's keys (gathered over
    the tp group by `gather`, tensor_parallel_state_dict)."""
    for p in model.parameters():
        p.data = p.grad if p.grad is not None else torch.zeros_like(p)
    return dict(model.state_dict()) if gather is None else gather(model)


def _train(d: Path, inp, mesh=None) -> dict:
    """Two forecast AdamW steps of the "train" model (placed over `mesh`
    when given): the losses and the parameters after them, under the full
    model's keys."""
    from vaevar_tpu_torch.parallel.tensor_parallel import (
        shard_tensor_parallel,
        tensor_parallel_state_dict,
    )
    from vaevar_tpu_torch.train.forecast_trainer import make_forecast_train_step

    model = _model(d, "train")
    if mesh is not None:
        shard_tensor_parallel(model, mesh)
    init_fn, step = make_forecast_train_step(model, loss_type="LpLoss", lr=1e-3, total_steps=2,
                                             out_shape=(2 * NC, *HW))
    trainable, opt = init_fn()
    losses = []
    for s in range(2):
        trainable, opt, loss = step(trainable, opt, inp[s], [0.9 * inp[s]])
        losses.append(float(loss))
    params = tensor_parallel_state_dict(model) if mesh is not None else model.state_dict()
    return {"train.losses": torch.tensor(losses, dtype=torch.float64),
            **{f"train.p.{k}": v for k, v in params.items()}}


def _moe(d: Path, x, mesh=None, rng_seed=None):
    """MoEMlp (E experts) forward and gradients of mean(y^2) + z + b, the
    experts placed over `mesh` when given; with `rng_seed`, the router's
    jitter from a generator of that seed."""
    from vaevar_tpu_torch.models import zoo
    from vaevar_tpu_torch.parallel.tensor_parallel import shard_experts

    m = zoo.MoEMlp(16, 32, num_experts=E)
    m.load_state_dict(torch.load(d / "moe.pt"), strict=True)
    if mesh is not None:
        shard_experts(m, mesh)
    xg = x.clone().requires_grad_(True)
    rng = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    y, z, b = m(xg, rng=rng)
    (torch.mean(y ** 2) + z + b).backward()
    out = {"y": y.detach(), "z": z.detach(), "b": b.detach(), "xgrad": xg.grad}
    out.update({f"g.{k}": p.grad for k, p in m.named_parameters()})
    return out


def _single(d: Path) -> dict:
    inp = {k: torch.from_numpy(v) for k, v in np.load(d / "inputs.npz").items()}
    out = {}
    for name in ("relbias", "rope", "micro"):
        m = _model(d, name)
        r = _fwd_bwd(m, inp["x"], inp["u"])
        out.update({f"{name}.{k}": v for k, v in r.items()})
        out.update({f"{name}.g.{k}": v for k, v in _grads(m).items()})
    out.update(_train(d, inp["train"]))
    for seed in (None, 3):
        r = _moe(d, inp["moe_x"], rng_seed=seed)
        out.update({f"moe{seed}.{k}": v for k, v in r.items()})
    return {k: v.detach().numpy() for k, v in out.items()}


def _worker(d: Path):
    torch.set_num_threads(1)
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.parallel.tensor_parallel import (
        shard_tensor_parallel,
        tensor_parallel_report,
        tensor_parallel_state_dict,
    )

    rank = pmesh.init_distributed(backend="gloo", device="cpu")
    meshes = {tp: pmesh.spatial_mesh_from_arg(arg, "cpu") for tp, arg in TP_MESH.items()}
    inp = {k: torch.from_numpy(v) for k, v in np.load(d / "inputs.npz").items()}
    out, meta = {}, {"rank": rank, "reports": {}, "roundtrip": {},
                     "coords": {tp: m.coords for tp, m in meshes.items()}}
    for name, tp in CASES:
        m = _model(d, name)
        whole = {k: v.clone() for k, v in m.state_dict().items()}
        shard_tensor_parallel(m, meshes[tp])
        back = tensor_parallel_state_dict(m)
        meta["roundtrip"][f"{name}{tp}"] = (sorted(back) == sorted(whole) and all(
            torch.equal(back[k], whole[k]) for k in whole))
        meta["reports"][f"{name}{tp}"] = tensor_parallel_report(m)
        meta[f"{name}{tp}.param_numel"] = sum(p.numel() for p in m.parameters())
        r = _fwd_bwd(m, inp["x"], inp["u"])
        out.update({f"{name}{tp}.{k}": v for k, v in r.items()})
        out.update({f"{name}{tp}.g.{k}": v
                    for k, v in _grads(m, tensor_parallel_state_dict).items()})
    out.update(_train(d, inp["train"], meshes[2]))
    for ep in EP:
        mesh = pmesh.expert_mesh(ep)
        meta[f"ep{ep}"] = [mesh.ep, mesh.index]
        for seed in (None, 3):
            r = _moe(d, inp["moe_x"], mesh, seed)
            out.update({f"ep{ep}.moe{seed}.{k}": v for k, v in r.items()})
    # the spatial group of a tp x sh x sw mesh sums a tile's partials alone
    tile = pmesh.tile_for(meshes[2], (4, 8))
    (s,) = pmesh.sum_over_tiles(tile, torch.tensor([float(rank + 1)]))
    meta["spatial_sum"] = float(s)
    np.savez(d / f"rank{rank}.npz", **{k: v.detach().numpy() for k, v in out.items()})
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(meta, f)
    torch.distributed.destroy_process_group()


# --- the parent: weights, inputs, one process, JAX --------------------------


def _jax_tp(name, cfg, inputs, tp, grads=True):
    """JAX's forward (and gradients of mean(y^2), as the port's keys) of the
    LGUnet `name`, placed by its shard_tensor_parallel on a {"tp": tp}
    mesh."""
    import jax
    import jax.numpy as jnp

    from torch_port_util import flax_params
    from vaevar_tpu.models.lgunet import LGUnet
    from vaevar_tpu.parallel import mesh as jmesh
    from vaevar_tpu_torch.utils.port_jax import lgunet_state_dict_from_flax

    model = LGUnet(cfg)
    params = flax_params(cfg, SEEDS[name])
    mesh = jmesh.make_mesh({"tp": tp}, jax.devices()[:tp])
    placed = jmesh.shard_tensor_parallel(params, mesh)
    x = jnp.asarray(inputs["x"])
    if not grads:
        return {"y": np.asarray(jax.jit(model.apply)(placed, x))}

    def loss(p):
        y = model.apply(p, x)
        return jnp.mean(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(placed)
    sd = lgunet_state_dict_from_flax(jax.tree.map(np.asarray, g), cfg)
    return {"y": np.asarray(y), **{f"g.{k}": v.numpy() for k, v in sd.items()}}


def _jax_ep(params, inputs, ep):
    """JAX's MoEMlp with its banks placed by shard_experts over {"ep": ep}:
    y, z, b and the gradients of mean(y^2) + z + b, as the port's keys."""
    import jax
    import jax.numpy as jnp

    from vaevar_tpu.models import zoo as jzoo
    from vaevar_tpu.parallel import mesh as jmesh
    from vaevar_tpu_torch.utils.port_jax import zoo_state_dict_from_flax

    m = jzoo.MoEMlp(16, 32, num_experts=E)
    mesh = jmesh.make_mesh({"ep": ep}, jax.devices()[:ep])
    placed = jmesh.shard_experts(params, mesh, E)
    x = jnp.asarray(inputs["moe_x"])

    def loss(p, v):
        y, z, b = m.apply(p, v)
        return jnp.mean(y ** 2) + z + b, (y, z, b)

    (_, (y, z, b)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                          has_aux=True))(placed, x)
    out = {"y": np.asarray(y), "z": np.asarray(z), "b": np.asarray(b), "xgrad": np.asarray(gx)}
    out.update({f"g.{k}": v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in zoo_state_dict_from_flax(jax.tree.map(np.asarray, gp)).items()})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from torch_port_util import model_pair, rand
    from vaevar_tpu import config as C
    from vaevar_tpu.models import zoo as jzoo
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models.init import without_default_init
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init
    from vaevar_tpu_torch.utils.port_jax import zoo_state_dict_from_flax

    d = tmp_path_factory.mktemp("tp")
    cfgs = _configs(C)
    for name, cfg in cfgs.items():  # JAX's fast_init draw, bit for bit
        if cfg.lora_rank:  # a layout the port's fast_init does not draw: through the bridge
            m = model_pair(cfg, SEEDS[name])[2]
        else:
            with without_default_init():
                m = fast_init(LGUnet(_configs(tcfg)[name]), seed=SEEDS[name])
        torch.save(m.state_dict(), d / f"{name}.pt")
    moe_x = rand(MOE_X, 11)
    moe_params = jax.tree.map(np.asarray, jzoo.MoEMlp(16, 32, num_experts=E).init(
        jax.random.PRNGKey(0), moe_x))
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in zoo_state_dict_from_flax(moe_params).items()}, d / "moe.pt")
    inputs = dict(x=rand((1, NC, *HW), 5), u=rand((1, NC, *HW), 6),
                  train=rand((2, 2, NC, *HW), 7), moe_x=moe_x)
    np.savez(d / "inputs.npz", **inputs)

    n = 4
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(d)], cwd=REPO, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    try:
        torch.set_num_threads(1)
        single = _single(d)
        jax_tp = {(name, tp): _jax_tp(name, cfgs[name], inputs, tp, grads=False)
                  for name, tp in JAX_FAST}
        jax_ep = {ep: _jax_ep(moe_params, inputs, ep) for ep in EP}
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}\n{e[-6000:]}"
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
    meta = [json.load(open(d / f"rank{r}.json")) for r in range(n)]
    return dict(inputs=inputs, single=single, jax_tp=jax_tp, jax_ep=jax_ep, ranks=ranks,
                meta=meta, cfgs=cfgs)


def _grad_keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def _check_grads(got, want, rtol, atol):
    keys = _grad_keys(want, "g.")
    assert keys and keys == _grad_keys(got, "g."), (keys, _grad_keys(got, "g."))
    for k in keys:
        np.testing.assert_allclose(got[f"g.{k}"], want[f"g.{k}"], rtol=rtol, atol=atol,
                                   err_msg=k)


def _case(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


# --- the placement ------------------------------------------------------------


@pytest.mark.parametrize("name, tp", CASES)
def test_placement_matches_one_process(world, name, tp):
    """Forward, gathered parameter gradients, input gradient and jvp slope
    of the placed model against the unplaced one, on rank 0."""
    got = _case(world["ranks"][0], f"{name}{tp}.")
    want = _case(world["single"], f"{name}.")
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
    _check_grads(got, want, 5e-4, 1e-5)
    scale = np.abs(want["xgrad"]).max()
    np.testing.assert_allclose(got["xgrad"], want["xgrad"], rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got["slope"], want["slope"], rtol=1e-5)
    print(f"{name} tp {tp}: max |dy| {np.abs(got['y'] - want['y']).max():.3g}, slope "
          f"{float(got['slope']):.8g} ({float(want['slope']):.8g})")


@pytest.mark.parametrize("name, tp", JAX_FAST)
def test_placement_matches_jax_shard_tensor_parallel(world, name, tp):
    got = _case(world["ranks"][0], f"{name}{tp}.")
    np.testing.assert_allclose(got["y"], world["jax_tp"][(name, tp)]["y"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.slow
@pytest.mark.parametrize("name, tp", CASES)
def test_placement_gradients_match_jax_shard_tensor_parallel(world, name, tp):
    """The forward and the gathered parameter gradients of every case
    against JAX's placement. Slow tier: JAX compiles each placement's
    forward and gradients for 15-25 s on one CPU thread."""
    got = _case(world["ranks"][0], f"{name}{tp}.")
    want = _jax_tp(name, world["cfgs"][name], world["inputs"], tp)
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
    _check_grads(got, want, 5e-4, 1e-5)


@pytest.mark.parametrize("name, tp", CASES)
def test_state_dict_round_trip_and_report(world, name, tp):
    """tensor_parallel_state_dict(shard_tensor_parallel(m)) is m's state
    dict bit for bit on every rank; the report names each stage's split, and
    the rank holds its share of the split weights."""
    heads = {"relbias": [4], "rope": [2, 4], "micro": [1]}[name]
    hidden = {"relbias": 128, "rope": 128, "micro": 64}[name]
    for m in world["meta"]:
        assert m["roundtrip"][f"{name}{tp}"]
        report = m["reports"][f"{name}{tp}"]
        assert len(report) == len(heads)
        for line, h in zip(report, heads):
            want = (f"attention {h // tp} of {h} heads per rank" if h % tp == 0
                    else f"attention whole ({h} head{'s' * (h > 1)} on every rank)")
            assert want in line and f"mlp {hidden // tp} of {hidden} hidden units" in line, line
    whole = sum(v.size for k, v in world["single"].items() if k.startswith(f"{name}.g."))
    assert world["meta"][0][f"{name}{tp}.param_numel"] < whole


def test_ranks_agree_bitwise(world):
    """Every number but an expert bank's gradient (each ep rank's own
    experts) is the same on every rank."""
    ranks = world["ranks"]
    for k in ranks[0]:
        if k.startswith("ep") and k.split(".")[-1] in ("w1", "b1", "w2", "b2"):
            continue
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")


def test_mesh_layout_and_spatial_group(world):
    """Ranks sit as JAX's make_mesh lays out ("tp", "sh", "sw"): rank = t sh
    sw + s sw + w; under 2x1x2 a tile's sums run over its spatial group
    alone (ranks {0, 1} and {2, 3}: 1 + 2 and 3 + 4)."""
    for r, m in enumerate(world["meta"]):
        assert m["coords"]["2"] == {"tp": r // 2, "sh": 0, "sw": r % 2}
        assert m["coords"]["4"] == {"tp": r, "sh": 0, "sw": 0}
        assert m["spatial_sum"] == (3.0 if r < 2 else 7.0)
        assert m["ep2"] == [2, r % 2] and m["ep4"] == [4, r]


def test_tensor_parallel_training_matches_one_process(world):
    got, want = world["ranks"][0], world["single"]
    np.testing.assert_allclose(got["train.losses"], want["train.losses"], rtol=1e-5)
    keys = _grad_keys(want, "train.p.")
    assert keys == _grad_keys(got, "train.p.")
    for k in keys:
        np.testing.assert_allclose(got[f"train.p.{k}"], want[f"train.p.{k}"], rtol=5e-4,
                                   atol=5e-6, err_msg=k)


# --- expert parallelism -------------------------------------------------------


def _check_moe(got, want):
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-6, atol=1e-6)
    for k in ("z", "b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["xgrad"], want["xgrad"], rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("ep", EP)
@pytest.mark.parametrize("seed", [None, 3])
def test_shard_experts_matches_one_process(world, ep, seed):
    """Each rank's expert block against the single process's bank, with the
    same router generator (seed 3) or no router noise."""
    n = E // ep
    for r, ranks in enumerate(world["ranks"]):
        got = _case(ranks, f"ep{ep}.moe{seed}.")
        want = _case(world["single"], f"moe{seed}.")
        _check_moe(got, want)
        idx = world["meta"][r][f"ep{ep}"][1]
        for k in want:
            if not k.startswith("g."):
                continue
            w = want[k]
            if k.split(".")[-1] in ("w1", "b1", "w2", "b2"):
                w = w[idx * n:(idx + 1) * n]
            np.testing.assert_allclose(got[k], w, rtol=5e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ep", EP)
def test_shard_experts_matches_jax_shard_experts(world, ep):
    n = E // ep
    want = world["jax_ep"][ep]
    for r, ranks in enumerate(world["ranks"]):
        got = _case(ranks, f"ep{ep}.moeNone.")
        _check_moe(got, want)
        idx = world["meta"][r][f"ep{ep}"][1]
        for k in want:
            if k.startswith("g."):
                w = want[k]
                if k.split(".")[-1] in ("w1", "b1", "w2", "b2"):
                    w = w[idx * n:(idx + 1) * n]
                np.testing.assert_allclose(got[k], w, rtol=5e-5, atol=1e-6, err_msg=k)


def test_hidden_width_not_divisible_raises():
    """tp 3 divides the micro LG stage's 64 hidden units no more than its
    16 channels: the placement names the layer and changes nothing."""
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh

    m = LGUnet(tcfg.micro_config(img_size=HW, **GROUPS))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pytest.raises(ValueError, match=r"net\.layers\.0\.blocks\.0\.mlp: hidden width 64"):
        pmesh.shard_tensor_parallel(m, pmesh.SpatialMesh(1, 1, 0, tp=3))
    after = m.state_dict()
    assert sorted(after) == sorted(before) and all(torch.equal(after[k], before[k])
                                                   for k in before)
    assert pmesh.shard_tensor_parallel(m, pmesh.SpatialMesh(1, 1)) is m  # tp 1 places nothing


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
