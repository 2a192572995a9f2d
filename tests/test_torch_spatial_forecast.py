"""The forecast trainer's spatial mesh (run_train_forecast --mesh DPxSHxSW)
against one process and against the JAX package.

Three worlds of gloo ranks in subprocesses on the CPU, one torch thread
each (this file is also the worker: `python tests/test_torch_spatial_forecast.py
<dir> <mesh>` with torchrun's environment): 1x1x2 (2 ranks), 1x1x3 (3) and
2x1x2 (4). The model is the micro rope LGUnet at 16x48 with LG stages
(1, 2) (`micro_config(img_size=(16, 48), lg_depths=(1, 2), lg_heads=(1,
1))`, two variable groups of 4 + 13 channels as tests/test_torch_train.py,
flash_min_seq 48): a full-grid LG stage 0 of 48 tokens that runs flash (the
port's plain flash functions here, JAX's ops/flash.py) and a windowed,
shifted stage 1 on a 4x12 grid of 3 window columns, which sw=2 cuts (the
window-aligned tiles hold 8 + 4 columns); the encoder's second level, the
LG stages and the decoder's first level sit on that grid, as FORECAST_025's
do on its 90x180 grid. The same with enc_depths (2, 2) shifts the encoder's
and decoder's blocks too. In each world:
- `retile` between two column layouts and `halo_roll` on uneven tiles,
  against the identity and torch.roll of the assembled field, and
  `gather_whole` against the whole field: forward, backward and forward
  mode;
- both models partitioned, remat off and on: output, input gradient and
  parameter gradients of sum(out * g), summed over the spatial group; each
  rank's activations at each level; the exchanges counted;
- 2 AdamW steps at b2 (make_forecast_train_step with the mesh), Possloss
  and LpLoss, one- and two-step;
- (1x1x2, 2x1x2) run_train_forecast --micro --grid 32x64 --mesh, 2 steps
  and a validation; the 1x1x2 run resumed for a second epoch.
While they run, this process computes the same in one process, and six JAX
processes JAX's LGUnet.apply and its global train steps. The slow tier
adds JAX's meshed steps (make_mesh({"dp", "sh", "sw"}) on the forced host
devices, the batch at P(dp, None, sh, sw)) and JAX's run_train_forecast.py
--micro --mesh 1x1x2 (each ~20-50 s of JAX compile).

Tolerances, with the reason (tests/test_torch_spatial_train.py's):
- the moves against the assembled field: bitwise in all three modes (they
  move data only; the gather's backward sums integer-valued gradients).
- the partitioned LGUnet against one process and JAX: forward rtol 1e-4,
  atol 1e-5; input and parameter gradients atol 1e-3 x max|g| (f32 sums in
  other orders; the ranks' parameter gradients are summed in another order).
- the train steps against one process, JAX's global step and JAX's meshed
  step: loss rtol 1e-5; gradients (the logvar bounds' included) rtol 1e-3
  with atol 1e-4 x max; trainables after 1 and 2 steps atol 2.5 x lr (f32
  round-off through ~30 layers; Adam turns a round-off gradient into a
  +-lr step).
- the CLI against one process and JAX's CLI: losses and the validation loss
  rtol 1e-5, the weights atol 2.5 x lr.
- the ranks: bitwise equal (every rank receives the same gradient sum).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
HW = (16, 48)
NC = 17
GROUPS = dict(inchans_list=(4, 13), outchans_list=(8, 26))
LR, TOTAL = 1e-4, 4
MESHES = {"1x1x2": 2, "1x1x3": 3, "2x1x2": 4}
VARIANTS = [("Possloss", False), ("Possloss", True), ("LpLoss", False), ("LpLoss", True)]
FIELD = (2, 4, 20, 3)  # (B, H, W, C) of the moves
# the column counts of two layouts of FIELD's 20 columns over 2 and 3 ranks
COUNTS = {2: ((10, 10), (12, 8)), 3: ((7, 7, 6), (8, 8, 4))}
SHIFTS = (2, -2, 4, -4, 3)
CLI = ["--device", "cpu", "--micro", "--grid", "32x64", "--steps", "2", "--end_time",
       "2022-01-04 00:00:00", "--no-bf16", "--log_every", "1"]
# the shifted blocks of each model (each rolls twice along lon), and the
# re-tilings per pass at sw = 2 (both groups' encoder level 1 in, decoder
# level 1 out); at sw = 3 every level's even tiles hold whole windows
SHIFTED = {"lg": 1, "enc2": 9}
RETILES = {2: 4, 3: 0}


def _configs(C):
    base = C.micro_config(img_size=HW, lg_depths=(1, 2), lg_heads=(1, 1), flash_min_seq=48,
                          **GROUPS)
    return {"lg": base, "enc2": base.replace(enc_depths=(2, 2))}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _inputs() -> dict:
    out = dict(field=_rand(FIELD, 1), field_g=_rand(FIELD, 2), field_t=_rand(FIELD, 3),
               field_i=np.round(4 * _rand(FIELD, 4)), x=_rand((2, NC, *HW), 5),
               g=_rand((2, 2 * NC, *HW), 6))
    for k in range(2):  # the two steps' batches: input and two targets
        out[f"x{k}"] = _rand((2, NC, *HW), 10 + 10 * k)
        for s in range(2):
            out[f"t{k}{s}"] = _rand((2, NC, *HW), 11 + 10 * k + s)
    return out


# --- one rank ----------------------------------------------------------------


def _moves(tiling, inp):
    """retile, halo_roll and gather_whole of this rank's tiles of FIELD:
    their outputs, input gradients and tangents."""
    import torch.autograd.forward_ad as fwad

    from vaevar_tpu_torch.parallel import spatial

    n, w, grp = tiling.sw, tiling.w, tiling.lon_group
    src, dst = COUNTS[n]
    whole = {k: torch.from_numpy(inp[k]) for k in ("field", "field_g", "field_t", "field_i")}

    def tile(t, counts):
        return t[:, :, spatial.Layout((FIELD[1],), counts).tile(0, w)[1]].clone()

    def three(fn, counts_in, g):
        x = tile(whole["field"], counts_in).requires_grad_(True)
        y = fn(x)
        (y * g).sum().backward()
        with fwad.dual_level():
            t = fwad.unpack_dual(fn(fwad.make_dual(tile(whole["field"], counts_in),
                                                   tile(whole["field_t"], counts_in)))).tangent
        return y.detach().numpy(), x.grad.numpy(), t.numpy()

    out = {}
    got = three(lambda x: spatial.retile(x, src, dst, 2, w, grp), src,
                tile(whole["field_g"], dst))
    out.update(zip(("retile", "retilegrad", "retilejvp"), got))
    for k in SHIFTS:
        got = three(lambda x: spatial.halo_roll(x, k, 2, n, w, grp), dst,
                    tile(whole["field_g"], dst))
        out.update(zip((f"roll{k}", f"rollgrad{k}", f"rolljvp{k}"), got))
    layout = spatial.Layout((FIELD[1],), dst)
    # every rank's gradient of the whole differs: its lon index + 1 times an
    # integer-valued field, so that the sum over the ranks is exact
    got = three(lambda x: tiling.gather_whole(x, layout), dst, whole["field_i"] * (w + 1))
    out.update(zip(("gather", "gathergrad", "gatherjvp"), got))
    return out


def _net_run(cfg, sd, x, g, tiling=None, group=None):
    """The LGUnet `cfg` with weights `sd`, partitioned on `tiling` when
    given: its output, input gradient and parameter gradients of sum(out *
    g) (x and g whole; the partitioned run takes their tiles and sums its
    parameter gradients over `group`), the activations' shapes at each
    level and the exchanges of each kind."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.parallel import spatial

    model = LGUnet(cfg)
    model.load_state_dict(sd, strict=True)
    x, g = torch.from_numpy(x), torch.from_numpy(g)
    if tiling is not None:
        model.partition(tiling)
        rows, cols = tiling.tile(HW)
        x, g = x[..., rows, cols], g[..., rows, cols]
    shapes = {}

    def record(name):
        def hook(module, args, out):
            shapes.setdefault(name, list(out.shape))
        return hook

    for name in ("enc.enc_list.0.patch_embed", "enc.enc_list.0.layers.1", "net.layers.0", "net",
                 "dec.dec_list.0.layers_up.0"):
        model.get_submodule(name).register_forward_hook(record(name))
    counts = {"retile": 0, "halo": 0, "gather": 0}
    real = spatial._move, spatial._roll, spatial.Tiling._gather_whole

    def counted(kind, fn):
        return lambda *a: counts.__setitem__(kind, counts[kind] + 1) or fn(*a)

    spatial._move, spatial._roll = counted("retile", real[0]), counted("halo", real[1])
    spatial.Tiling._gather_whole = counted("gather", real[2])
    try:
        x = x.clone().requires_grad_(True)
        y = model(x)
        (y * g).sum().backward()
    finally:
        spatial._move, spatial._roll, spatial.Tiling._gather_whole = real
    if tiling is not None:
        pmesh.all_sum_grads(model.parameters(), group)
    out = {"y": y.detach().numpy(), "xg": x.grad.numpy()}
    out.update({f"grad.{k}": p.grad.numpy() for k, p in model.named_parameters()})
    return out, {"shapes": shapes, "counts": counts}


def _steps(cfg, sd, inp, loss_type, two_step, mesh=None):
    """Two make_forecast_train_step steps on the batches x0 and x1 (with
    `mesh`: this rank's dp rows and tile of them): the loss of each, the
    gradients of the first and the trainable after each."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train import forecast_trainer as ft

    model = LGUnet(cfg)
    model.load_state_dict(sd, strict=True)
    init_fn, step = ft.make_forecast_train_step(model.train(), loss_type, lr=LR,
                                                total_steps=TOTAL, two_step=two_step,
                                                out_shape=(2 * NC, *HW), mesh=mesh)
    trainable, opt_state = init_fn()
    lo, hi, rows, cols = 0, 2, slice(None), slice(None)
    if mesh is not None:
        lo, hi = mesh.batch_spec(2 // mesh.dp)
        rows, cols = mesh.tiling.tile(HW)
    out, losses = {}, []
    def part(key):
        return torch.from_numpy(inp[key][lo:hi, :, rows, cols].copy())

    for k in range(2):
        tars = [part(f"t{k}{s}") for s in range(1 + two_step)]
        trainable, opt_state, loss = step(trainable, opt_state, part(f"x{k}"), tars)
        losses.append(float(loss))
        if k == 0:
            out.update({f"grad.{n}": p.grad.numpy().copy() for n, p in _named(trainable)})
        out.update({f"state{k}.{n}": p.detach().numpy().copy() for n, p in _named(trainable)})
    out["loss"] = np.asarray(losses)
    return out


def _named(trainable):
    """(name, parameter) of the trainable in the JAX bridge's layout:
    model.<state_dict key>, max_logvar, min_logvar."""
    for k, p in trainable["model"].named_parameters():
        yield f"model.{k}", p
    for k in ("max_logvar", "min_logvar"):
        if k in trainable:
            yield k, trainable[k]


def _cli_runs(out: Path, batch: int, *flags, resume=True):
    """run_train_forecast --micro with `flags` for one epoch (the weights
    after it kept as params_epoch0), then, with `resume`, resumed for a
    second: the losses of each run and the first run's validation loss."""
    from vaevar_tpu_torch import run_train_forecast
    from vaevar_tpu_torch.parallel import mesh as pmesh

    argv = CLI + ["--batch_size", str(batch), *flags, "--out_dir", str(out)]
    _, first = run_train_forecast.main(argv)
    if pmesh.process_index() == 0:
        shutil.copy(out / "params_latest", out / "params_epoch0")
    with open(out / "scalars.jsonl") as f:
        val = [r["value"] for r in map(json.loads, f) if r["tag"] == "val_loss"]
    second = run_train_forecast.main(argv + ["--epochs", "2"])[1] if resume else []
    return {"losses": [list(first), list(second)], "val_loss": val[0]}


def _worker(d: Path, arg: str):
    torch.set_num_threads(1)
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.init_distributed(backend="gloo", device="cpu")
    mesh = pmesh.mesh_from_arg(arg, "cpu")
    inp = dict(np.load(d / "inputs.npz"))
    res = dict(_moves(mesh.tiling, inp))
    meta = {"rank": rank, "coords": mesh.coords, "net": {}}
    for name, cfg in _configs(tcfg).items():
        sd = torch.load(d / f"net_{name}.pt")
        for remat in (False, True):
            out, info = _net_run(cfg.replace(remat=remat), sd, inp["x"], inp["g"], mesh.tiling,
                                 mesh.group)
            res.update({f"net.{name}.{remat}.{k}": v for k, v in out.items()})
            meta["net"][f"{name}.{remat}"] = info
    cfg = _configs(tcfg)["lg"]
    sd = torch.load(d / "net_lg.pt")
    for loss_type, two_step in VARIANTS:
        out = _steps(cfg, sd, inp, loss_type, two_step, mesh)
        res.update({f"step.{loss_type}.{two_step}.{k}": v for k, v in out.items()})
    if arg != "1x1x3":  # the CLI: b2 globally, --batch_size per dp rank
        meta["cli"] = _cli_runs(d / f"cli_{arg}", 2 // mesh.dp, "--mesh", arg,
                                resume=arg == "1x1x2")
    np.savez(d / f"{arg}.rank{rank}.npz", **res)
    with open(d / f"{arg}.rank{rank}.json", "w") as f:
        json.dump(meta, f)


# --- JAX's train steps, in processes of their own ----------------------------


def _jax_steps(d: Path, arg, variants):
    """JAX's make_forecast_train_step, two steps on x0 and x1 for each of
    `variants` ("<loss type>.<two_step>"): with `arg` "global" the global step,
    else the one on the mesh `arg` (the batch at P(dp, None, sh, sw) on the
    forced host devices, the trainable replicated). The gradients are read
    from optax's first Adam moment, which after one update is (1 - b1) g.
    Writes jax_<arg>_<variants>.npz in the port's layout."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from torch_port_util import flax_params
    from vaevar_tpu import config as C
    from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
    from vaevar_tpu.parallel import mesh as jmesh
    from vaevar_tpu.train import forecast_trainer as jft
    from vaevar_tpu_torch.utils.port_jax import forecast_trainable_from_flax

    cfg = _configs(C)["lg"]
    params = flax_params(cfg, seed=1)
    inp = dict(np.load(d / "inputs.npz"))
    put, rep = jnp.asarray, (lambda t: t)
    if arg != "global":
        mesh = jmesh.mesh_from_arg(arg)
        put = lambda a: jax.device_put(a, NamedSharding(mesh, P("dp", None, "sh", "sw")))  # noqa: E731
        rep = lambda t: jmesh.replicate(t, mesh)  # noqa: E731

    def port(tree):
        ported = forecast_trainable_from_flax(jax.tree.map(np.asarray, tree), cfg)
        out = {f"model.{k}": v.numpy() for k, v in ported["model"].items()}
        out.update({k: v.numpy() for k, v in ported.items() if k != "model"})
        return out

    res = {}
    for variant in variants:
        loss_type, two_step = variant.split(".")
        two_step = two_step == "True"
        init_fn, step = jft.make_forecast_train_step(
            JaxLGUnet(cfg).apply, loss_type, lr=LR, total_steps=TOTAL, two_step=two_step,
            out_shape=(2 * NC, *HW))
        trainable, opt_state = (rep(t) for t in init_fn(params))
        step_j = jax.jit(step)
        pre, losses = f"{variant}.", []
        for k in range(2):
            tars = [put(inp[f"t{k}{s}"]) for s in range(1 + two_step)]
            trainable, opt_state, loss = step_j(trainable, opt_state, put(inp[f"x{k}"]), tars)
            losses.append(float(loss))
            if k == 0:
                res.update({pre + "grad." + n: v for n, v in port(jax.tree.map(
                    lambda m: np.asarray(m) / np.float32(0.1), opt_state[0].mu)).items()})
            res.update({pre + f"state{k}." + n: v for n, v in port(trainable).items()})
        res[pre + "loss"] = np.asarray(losses)
    np.savez(d / f"jax_{arg}_{'_'.join(variants)}.npz", **res)


# --- the parent --------------------------------------------------------------


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]),
                OMP_NUM_THREADS="1")


def _launch(d: Path, arg: str) -> list:
    n = MESHES[arg]
    env = dict(_env(), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n))
    return [subprocess.Popen([sys.executable, __file__, str(d), arg], cwd=REPO, text=True,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(n)]


def _jax_proc(d: Path, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--jax", str(d), *args], cwd=REPO,
                            text=True, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _join(procs, timeout=600):
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:]} failed:\n{o[-3000:]}\n{e[-6000:]}"


def _jax_net(d: Path, name: str):
    """JAX's LGUnet `name` (flax_params seed 1): its output, input gradient
    and parameter gradients of sum(out * g), in the port's layout; writes
    jax_net_<name>.npz."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from torch_port_util import flax_params
    from vaevar_tpu import config as C
    from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
    from vaevar_tpu_torch.utils.port_jax import lgunet_state_dict_from_flax

    cfg = _configs(C)[name]
    inp = dict(np.load(d / "inputs.npz"))
    jm, g = JaxLGUnet(cfg), jnp.asarray(inp["g"])

    def value_and_vjp(p, x):
        y, vjp = jax.vjp(jm.apply, p, x)
        return y, vjp(g)

    y, (gp, gx) = jax.jit(value_and_vjp)(flax_params(cfg, seed=1), jnp.asarray(inp["x"]))
    out = {"y": np.asarray(y), "xg": np.asarray(gx)}
    out.update({f"grad.{k}": v.numpy() for k, v in lgunet_state_dict_from_flax(
        jax.tree.map(np.asarray, gp), cfg).items()})
    np.savez(d / f"jax_net_{name}.npz", **out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train import checkpoint as tckpt
    from vaevar_tpu_torch.utils.fast_init import fast_init

    d = tmp_path_factory.mktemp("spatial_forecast")
    torch.set_num_threads(1)
    cfgs = _configs(tcfg)
    for name, cfg in cfgs.items():  # JAX's fast_init draw of seed 1, bit for bit
        torch.save(fast_init(LGUnet(cfg), seed=1).state_dict(), d / f"net_{name}.pt")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)

    procs = {arg: _launch(d, arg) for arg in MESHES}
    # JAX's LGUnet.apply and its global steps, a process each (~10-20 s of
    # compile each)
    jax_procs = ([_jax_proc(d, "net", name) for name in cfgs]
                 + [_jax_proc(d, "global", f"{lt}.{two}") for lt, two in VARIANTS])
    try:
        single = {}
        for name, cfg in cfgs.items():
            sd = torch.load(d / f"net_{name}.pt")
            for remat in (False, True):
                single[f"{name}.{remat}"] = _net_run(cfg.replace(remat=remat), sd, inp["x"],
                                                     inp["g"])[0]
        sd = torch.load(d / "net_lg.pt")
        single_steps = {v: _steps(cfgs["lg"], sd, inp, *v) for v in VARIANTS}
        cli_single = _cli_runs(d / "cli_single", 2)
        for arg in MESHES:
            _join(procs[arg])
        _join(jax_procs)
    finally:
        for p in [q for ps in procs.values() for q in ps] + jax_procs:
            p.kill()
    jax_net = {name: dict(np.load(d / f"jax_net_{name}.npz")) for name in cfgs}
    jax_steps = {}
    for lt, two in VARIANTS:
        jax_steps.update(np.load(d / f"jax_global_{lt}.{two}.npz"))
    return dict(
        dir=d, inputs=inp, single=single, jax_net=jax_net, single_steps=single_steps,
        jax_steps=jax_steps, cli_single=cli_single,
        cli_single_state=tckpt.restore(str(d / "cli_single" / "params_epoch0")),
        ranks={arg: [dict(np.load(d / f"{arg}.rank{r}.npz")) for r in range(n)]
               for arg, n in MESHES.items()},
        meta={arg: [json.load(open(d / f"{arg}.rank{r}.json")) for r in range(n)]
              for arg, n in MESHES.items()})


def _axes(arg):
    return tuple(int(v) for v in arg.split("x"))


def _assemble(parts, coords, sw, dim=-1):
    """The whole field from the lon tiles of the ranks of dp index 0."""
    tiles = [None] * sw
    for part, c in zip(parts, coords):
        if c["dp"] == 0:
            tiles[c["sw"]] = part
    return np.concatenate(tiles, dim)


# --- the moves -----------------------------------------------------------------


@pytest.mark.parametrize("arg", list(MESHES))
def test_retile_halo_and_gather_on_uneven_tiles_bitwise(world, arg):
    """retile between two column layouts (10 + 10 -> 12 + 8; 7 + 7 + 6 -> 8
    + 8 + 4) equals the identity on the assembled field, its backward the
    move back, its tangent the move; halo_roll by k on the uneven tiles
    equals torch.roll by k (backward by -k); gather_whole gives every rank
    the whole field, and its backward sums every rank's gradient of the
    whole (here (w + 1) x an integer field) over the ranks and keeps the
    tile. All bitwise."""
    _, _, sw = _axes(arg)
    inp, ranks = world["inputs"], world["ranks"][arg]
    coords = [m["coords"] for m in world["meta"][arg]]

    def whole(key):
        return _assemble([r[key] for r in ranks], coords, sw, 2)

    f, g, t = (torch.from_numpy(inp[k]) for k in ("field", "field_g", "field_t"))
    for key, want in (("retile", f), ("retilegrad", g), ("retilejvp", t)):
        np.testing.assert_array_equal(whole(key), want.numpy(), err_msg=key)
    for k in SHIFTS:
        for key, src, sign in (("roll", f, 1), ("rollgrad", g, -1), ("rolljvp", t, 1)):
            np.testing.assert_array_equal(whole(f"{key}{k}"),
                                          torch.roll(src, sign * k, 2).numpy(), err_msg=key)
    for r in ranks:
        np.testing.assert_array_equal(r["gather"], inp["field"])
        np.testing.assert_array_equal(r["gatherjvp"], inp["field_t"])
    np.testing.assert_array_equal(whole("gathergrad"),
                                  inp["field_i"] * sum(range(1, sw + 1)))


# --- the partitioned LGUnet ----------------------------------------------------------


def _net_whole(world, arg, key):
    ranks = world["ranks"][arg]
    coords = [m["coords"] for m in world["meta"][arg]]
    pre = f"net.{key}."
    out = {k: _assemble([r[pre + k] for r in ranks], coords, _axes(arg)[2]) for k in ("y", "xg")}
    out.update({k[len(pre):]: ranks[0][k] for k in ranks[0]
                if k.startswith(pre + "grad.")})
    return out


def _check_net(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-4, atol=1e-5)
    for k in want:
        if k == "y":
            continue
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * scale, err_msg=k)


@pytest.mark.parametrize("arg", list(MESHES))
@pytest.mark.parametrize("name", ["lg", "enc2"])
@pytest.mark.parametrize("remat", [False, True])
def test_partitioned_lgunet_equals_one_process_and_jax(world, arg, name, remat):
    got = _net_whole(world, arg, f"{name}.{remat}")
    _check_net(got, world["single"][f"{name}.{remat}"])
    _check_net(got, world["jax_net"][name])


@pytest.mark.parametrize("arg", list(MESHES))
def test_each_rank_holds_its_aligned_tile_and_runs_stage_0_whole(world, arg):
    """The patch embed's output and the decoder's first level (after
    PatchExpand) are this rank's even tile of the 8x24 grid; the encoder's
    second level and the LG stack's output its window-aligned tile of the
    4x12 grid (8 + 4 columns at sw = 2, 4 each at sw = 3); the full-grid LG
    stage's output is the whole grid on every rank. The exchanges: per pass
    two halo rolls per shifted block (forward, backward and, under remat,
    the recompute), the re-tilings in and out of the 4x12 level (forward
    and backward) and one gather of the full-grid stage's input (its
    backward is an all-reduce)."""
    _, _, sw = _axes(arg)
    aligned = {2: (8, 4), 3: (4, 4, 4)}[sw]
    for m in world["meta"][arg]:
        w = m["coords"]["sw"]
        for name in ("lg", "enc2"):
            for remat in (False, True):
                info = m["net"][f"{name}.{remat}"]
                assert info["shapes"] == {
                    "enc.enc_list.0.patch_embed": [2, 8, 24 // sw, 4],
                    "enc.enc_list.0.layers.1": [2, 4, aligned[w], 8],
                    "net.layers.0": [2, 4, 12, 16],
                    "net": [2, 4, aligned[w], 16],
                    "dec.dec_list.0.layers_up.0": [2, 8, 24 // sw, 4]}, (name, remat)
                halo = 2 * SHIFTED[name] * (3 if remat else 2)
                assert info["counts"] == {"retile": 2 * RETILES[sw], "halo": halo,
                                          "gather": 1}, (name, remat)


# --- the train steps ---------------------------------------------------------------


def _check_steps(got, want, what):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=what)
    grads = {k[5:]: v for k, v in want.items() if k.startswith("grad.")}
    assert sorted(k[5:] for k in got if k.startswith("grad.")) == sorted(grads)
    scale = max(np.abs(g).max() for g in grads.values())
    for k, g in grads.items():
        np.testing.assert_allclose(got["grad." + k], g, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"{what}: {k}")
    for k, v in want.items():
        if k.startswith("state"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=2.5 * LR, err_msg=f"{what}: {k}")


def _rank_steps(world, arg, loss_type, two_step, rank=0):
    pre = f"step.{loss_type}.{two_step}."
    r = world["ranks"][arg][rank]
    return {k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}


@pytest.mark.parametrize("arg", list(MESHES))
@pytest.mark.parametrize("loss_type,two_step", VARIANTS)
def test_train_steps_equal_one_process_and_jax_global_step(world, arg, loss_type, two_step):
    got = _rank_steps(world, arg, loss_type, two_step)
    _check_steps(got, world["single_steps"][(loss_type, two_step)], "one process")
    pre = f"{loss_type}.{two_step}."
    want = {k[len(pre):]: v for k, v in world["jax_steps"].items() if k.startswith(pre)}
    _check_steps(got, want, "JAX's global step")


@pytest.fixture(scope="module")
def jax_meshed(world):
    d = world["dir"]
    variants = [f"{lt}.{two}" for lt, two in VARIANTS]
    _join([_jax_proc(d, arg, *variants) for arg in MESHES], timeout=900)
    return {arg: dict(np.load(d / f"jax_{arg}_{'_'.join(variants)}.npz")) for arg in MESHES}


@pytest.mark.slow
@pytest.mark.parametrize("arg", list(MESHES))
def test_train_steps_equal_jax_meshed_step(world, jax_meshed, arg):
    """JAX's step on the same mesh, GSPMD-partitioned (12 compiles, ~3 min
    in three processes)."""
    for loss_type, two_step in VARIANTS:
        pre = f"{loss_type}.{two_step}."
        want = {k[len(pre):]: v for k, v in jax_meshed[arg].items() if k.startswith(pre)}
        _check_steps(_rank_steps(world, arg, loss_type, two_step), want,
                     f"JAX's {arg} step, {loss_type}, two_step {two_step}")


@pytest.mark.parametrize("arg", list(MESHES))
def test_ranks_agree_bitwise(world, arg):
    ranks = world["ranks"][arg]
    for k in ranks[0]:
        if k.startswith(("net.", "step.")) and not k.endswith((".y", ".xg")):
            for r in range(1, len(ranks)):
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")
    meta = world["meta"][arg]
    assert all(m.get("cli") == meta[0].get("cli") for m in meta)


# --- the CLI -----------------------------------------------------------------------


@pytest.mark.parametrize("arg", ["1x1x2", "2x1x2"])
def test_cli_mesh_equals_one_process(world, arg):
    """run_train_forecast --micro --grid 32x64 at b2 (--batch_size 1 per dp
    rank at 2x1x2): the losses, the validation loss and the weights after
    the first epoch; at 1x1x2 the resumed second epoch's losses too."""
    d = world["dir"]
    log = open(d / f"cli_{arg}" / "run.log").read()
    dp, sh, sw = _axes(arg)
    assert f"mesh: dp {dp} x sh {sh} x sw {sw}, rank 0 on cpu (gloo)" in log
    got, want = world["meta"][arg][0]["cli"], world["cli_single"]
    n = 2 if arg == "1x1x2" else 1
    assert [len(g) for g in got["losses"][:n]] == [len(w) for w in want["losses"][:n]]
    np.testing.assert_allclose(sum(got["losses"][:n], []), sum(want["losses"][:n], []),
                               rtol=1e-5)
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
    if arg == "1x1x2":
        assert "resumed at epoch 1 step 2" in log
    from vaevar_tpu_torch.train import checkpoint as tckpt

    a, b = tckpt.restore(str(d / f"cli_{arg}" / "params_epoch0")), world["cli_single_state"]
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=2.5 * 5e-6,
                                   err_msg=k)


@pytest.mark.slow
def test_cli_mesh_equals_jax_cli(world, tmp_path):
    """JAX's run_train_forecast.py --micro --mesh 1x1x2 on 2 forced host
    devices (~50 s): its validation loss against the port's 1x1x2 run."""
    cmd = [sys.executable, str(REPO / "run_train_forecast.py"), "--micro", "--grid", "32x64",
           "--batch_size", "2", "--steps", "2", "--end_time", "2022-01-04 00:00:00",
           "--no-bf16", "--log_every", "1", "--mesh", "1x1x2", "--out_dir", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(_env(), JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "scalars.jsonl") as f:
        rows = list(map(json.loads, f))
    val = [r["value"] for r in rows if r["tag"] == "val_loss"]
    losses = [r["value"] for r in rows if r["tag"] == "loss"]
    got = world["meta"]["1x1x2"][0]["cli"]
    np.testing.assert_allclose(got["losses"][0], losses, rtol=1e-5)
    assert got["val_loss"] == pytest.approx(val[0], rel=1e-5)


# --- FORECAST_025's geometry, partitioned without a forward pass ----------------------


def _forecast_025():
    """FORECAST_025's grid, patch, stride, windows and depths at narrow
    widths, one variable group."""
    from vaevar_tpu_torch import config as tcfg

    return tcfg.FORECAST_025.replace(inchans_list=(4,), outchans_list=(8,), enc_dim=4,
                                     embed_dim=8, enc_heads=(1, 1, 1), lg_heads=(1, 1, 1))


@pytest.mark.parametrize("arg,want", [
    ("1x1x2", {"enc.enc_list.0.layers.2": ((90, 90), (96, 84)),
               "dec.dec_list.0.layers_up.0": ((96, 84), (90, 90))}),
    ("1x1x4", {"enc.enc_list.0.layers.1": ((90,) * 4, (96, 96, 84, 84)),
               "enc.enc_list.0.layers.2": ((48, 48, 42, 42), (48, 48, 48, 36)),
               "dec.dec_list.0.layers_up.0": ((48, 48, 48, 36), (48, 48, 42, 42)),
               "dec.dec_list.0.layers_up.1": ((96, 96, 84, 84), (90,) * 4)}),
    ("2x1x2", {"enc.enc_list.0.layers.2": ((90, 90), (96, 84)),
               "dec.dec_list.0.layers_up.0": ((96, 84), (90, 90))}),
])
def test_forecast_025_partitions_on_window_aligned_tiles(arg, want):
    """721x1440 at sw 2: the 90x180 level's 15 window columns of 12 split 8
    + 7 (96 + 84 columns); at sw 4: 4, 4, 4, 3 there and 8, 8, 7, 7 at
    180x360. Each re-tiling (from, to) of every re-tiled level, and the LG
    stack's tiles; the full-grid stage partitions (run whole)."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.parallel.spatial import Tiling

    _, sh, sw = pmesh.parse_train_mesh(arg)
    model = LGUnet(_forecast_025()).partition(Tiling(sh, sw))
    got = {}
    for name, m in model.named_modules():
        for move in getattr(m, "moves", (None, None)):
            if move is not None and name != "net":
                got[name] = (move[0].cols, move[1].cols)
    assert got == want
    assert model.net.layout.cols == want["enc.enc_list.0.layers.2"][1]
    assert model.net.moves == (None, None)


@pytest.mark.parametrize("arg,match", [
    ("1x2x1", "kernel 3, stride 2 along lat"),
    ("1x1x16", "level 2: its 90x180 grid has 15 columns of 6x12 windows for the 16 ranks of "
               "the mesh axis sw=16"),
])
def test_forecast_025_refuses_what_cannot_tile(arg, match):
    """sh = 2: the lat patch kernel 3 at stride 2 reads across tiles; sw =
    16: more ranks than the 90x180 level's 15 window columns. ValueError,
    and the model stays whole."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.parallel.spatial import Tiling

    _, sh, sw = pmesh.parse_train_mesh(arg)
    model = LGUnet(_forecast_025())
    with pytest.raises(ValueError, match=match):
        model.partition(Tiling(sh, sw))
    assert model._tiling is None
    assert all(getattr(m, "moves", (None, None)) == (None, None) for m in model.modules())


if __name__ == "__main__":
    # --jax <dir> net <model>, or --jax <dir> <mesh or global> <loss type>.<two_step>...
    if sys.argv[1] == "--jax":
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        os.environ["JAX_PLATFORMS"] = "cpu"
        if sys.argv[3] == "net":
            _jax_net(Path(sys.argv[2]), sys.argv[4])
        else:
            _jax_steps(Path(sys.argv[2]), sys.argv[3], sys.argv[4:])
    else:
        _worker(Path(sys.argv[1]), sys.argv[2])
