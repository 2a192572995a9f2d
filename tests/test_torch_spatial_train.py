"""The VAE trainer's spatial mesh (run_train_vae --mesh DPxSHxSW) against one
process and against the JAX package.

Four gloo ranks in subprocesses on the CPU, one torch thread each (this file
is also the worker: `python tests/test_torch_spatial_train.py <dir>` with
torchrun's environment), form two meshes over the same world: 1x2x2 (one dp
row of 2 x 2 tiles) and 2x1x2 (two dp rows of lon halves). On them:
- the halo shift (parallel/spatial.py) of a (2, 8, 16, 3) field on the 2 x 2
  tiles, forward, backward and forward-mode;
- the micro relbias LGUnet (`micro_vae_configs(img_size=(32, 64))`'s
  decoder, with 2 blocks per stage so that its odd blocks shift and their
  halos cross the tiles) partitioned on the 2 x 2 and the 1 x 2 tiling,
  remat off and on: the output tile, the input gradient tile and the
  parameter gradients of sum(out * g), summed over the spatial group;
- one and two VAE train steps (make_vae_train_step with the mesh) on a global
  batch of 2 with JAX's noise for the global latent;
- run_train_vae --micro --grid 32x64 --mesh 1x2x2, one epoch of 2 steps,
  then resumed for a second.
While they run, this process computes the same on one process and on JAX.

Tolerances, with the reason:
- the halo shift against torch.roll of the assembled field: bitwise in all
  three modes (it moves data only).
- the partitioned LGUnet against one process and JAX's LGUnet.apply on the
  same bridged weights: forward rtol 1e-4, atol 1e-5; input and parameter
  gradients atol 1e-3 x max|g| (tests/test_torch_lgunet.py's: f32 sums in
  other orders; the tiles sum the parameter gradients in another order).
- the VAE steps against JAX's make_vae_train_step on the global batch:
  loss, rec and kld rtol 1e-5; gradients rtol 1e-3 with atol 1e-4 x max;
  parameters after 2 steps atol 2.5 x lr (tests/test_torch_vae_train.py's:
  f32 round-off through ~30 layers, Adam turning a round-off gradient into
  a +-lr step).
- the CLI at 1x2x2 against one process: the logged losses rtol 1e-5, the
  final weights atol 2.5 x lr (2 Adam steps, as above).
- the ranks: bitwise equal everywhere (the gradients are all-reduced, every
  rank receives the same sum).
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
HW = (32, 64)
NC, NMC, SIGMA, LR = 17, 2, 2.0, 1e-4
MESHES = ("1x2x2", "2x1x2")
LATENT_HALF = (16, 32)
FIELD = (2, 8, 16, 3)  # (B, H, W, C) of the halo shift, on 2 x 2 tiles of 4 x 8
SHIFTS = [(2, 2), (-2, -2), (-2, 0), (0, 3), (1, -5), (4, -8), (-4, 8)]
CLI = ["--device", "cpu", "--micro", "--fast_init", "--grid", "32x64", "--batch_size", "2",
       "--end_time", "2022-01-03 00:00:00", "--no-bf16", "--epochs", "1"]


def _configs(C):
    """The micro relbias LGUnet of the model test, and the VAE test's NMC
    flow model, encoder and decoder (two variable groups, 4 + 13 channels),
    all relbias: none has a full-grid stage, so all partition. The model has
    2 blocks per stage (the odd ones shifted, so their halos cross the
    tiles); the VAE test's models keep the micro config's one, as
    tests/test_torch_vae_train.py's (JAX's compile of a deeper step would
    take the file past its budget; the card's smoke runs a deeper VAE step
    partitioned)."""
    net = C.micro_vae_configs(img_size=HW)[1].replace(enc_depths=(2, 2), lg_depths=(2,))
    flow = C.micro_config(img_size=HW, attn_type="relbias", inchans_list=(4, 13),
                          outchans_list=(8, 26))
    enc = flow.replace(outchans_list=(4, 12))
    return net, flow, enc, enc.replace(inchans_list=(2, 6), outchans_list=(4, 13))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _inputs() -> dict:
    return dict(field=_rand(FIELD, 1), field_g=_rand(FIELD, 2), field_t=_rand(FIELD, 3),
                x=_rand((2, 8, *HW), 4), g=_rand((2, 69, *HW), 5),
                frames0=_rand((2, NMC + 1, NC, *HW), 10), frames1=_rand((2, NMC + 1, NC, *HW), 11))


# --- one rank ----------------------------------------------------------------


def _net_run(cfg, sd, x, g, tiling=None, group=None):
    """The LGUnet `cfg` with weights `sd`, partitioned on `tiling` when
    given: its output, input gradient and parameter gradients of sum(out *
    g) (x and g whole; the partitioned run takes their tiles and sums its
    parameter gradients over `group`), and the tile shapes at the patch
    embed and at the LG stage."""
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

    model.enc.enc_list[0].patch_embed.register_forward_hook(record("patch_embed"))
    model.net.register_forward_hook(record("lg_stage"))
    x = x.clone().requires_grad_(True)
    gather, halos = spatial._all_gather, []
    spatial._all_gather = lambda t, group=None: halos.append(t.shape) or gather(t, group)
    try:
        y = model(x)
        (y * g).sum().backward()
    finally:
        spatial._all_gather = gather
    shapes["halos"] = len(halos)
    if tiling is not None:
        pmesh.all_sum_grads(model.parameters(), group)
    out = {"y": y.detach().numpy(), "xg": x.grad.numpy()}
    out.update({f"grad.{k}": p.grad.numpy() for k, p in model.named_parameters()})
    return out, shapes


def _vae_steps(d: Path, inp, mesh=None):
    """Two make_vae_train_step steps (with `mesh`: this rank's rows and
    tile of the global batch and of the noise): the metrics of each, the
    gradients of the first and the parameters after each."""
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.train import vae_trainer as vt

    _, flow_cfg, enc, dec = _configs(tcfg)
    flow = LGUnet(flow_cfg)
    flow.load_state_dict(torch.load(d / "flow.pt"), strict=True)
    flow.eval().requires_grad_(False)
    vae = VAE(enc, dec)
    vae.load_state_dict(torch.load(d / "vae.pt"), strict=True)
    init_fn, step = vt.make_vae_train_step(vae, flow, sigma=SIGMA, lr=LR, latent_hw=HW,
                                           nmc_steps=NMC, mesh=mesh)
    opt = init_fn()
    lo, hi, rows, cols = 0, 2, slice(None), slice(None)
    if mesh is not None:
        lo, hi = mesh.batch_spec(2 // mesh.dp)
        rows, cols = mesh.tiling.tile(HW)
    out, metrics = {}, []
    for k in range(2):
        frames = torch.from_numpy(inp[f"frames{k}"][lo:hi, ..., rows, cols].copy())
        eps = torch.from_numpy(inp[f"eps{k}"][lo:hi, ..., rows, cols].copy())
        m = step(opt, frames, eps)
        metrics.append({key: float(v) for key, v in m.items()})
        if k == 0:
            out.update({f"vgrad.{n}": p.grad.numpy().copy() for n, p in vae.named_parameters()})
        out.update({f"state{k}.{n}": v.numpy().copy() for n, v in vae.state_dict().items()})
    # the error sample on a latent grid of half the frames' (a resize that
    # gathers the tiles first)
    frames = torch.from_numpy(inp["frames0"][lo:hi, ..., rows, cols].copy())
    out["err_half"] = vt.nmc_error_sample(frames, flow, LATENT_HALF, NMC,
                                          tiling=None if mesh is None else mesh.tiling).numpy()
    return out, metrics


def _cli_runs(out: Path, *flags):
    """run_train_vae --micro with `flags` for one epoch, then resumed for a
    second: the losses of each run and the VAE's checksum after the second;
    the first run's vae_latest is kept as vae_epoch0 (rank 0 copies it)."""
    import shutil

    from vaevar_tpu_torch import run_train_vae
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.train import vae_trainer as vt

    _, first = run_train_vae.main(CLI + [*flags, "--out_dir", str(out)])
    if pmesh.process_index() == 0:
        shutil.copy(out / "vae_latest", out / "vae_epoch0")
    vae, second = run_train_vae.main(CLI + [*flags, "--out_dir", str(out), "--epochs", "2"])
    return [[h["loss"] for h in first], [h["loss"] for h in second]], vt.replicated_checksum(vae)


def _worker(d: Path):
    torch.set_num_threads(1)
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.init_distributed(backend="gloo", device="cpu")
    meshes = {arg: pmesh.mesh_from_arg(arg, "cpu") for arg in MESHES}
    inp = dict(np.load(d / "inputs.npz"))
    res = {}
    meta = {"rank": rank, "coords": {a: m.coords for a, m in meshes.items()}}

    # the halo shift on the 2 x 2 tiles: forward, backward, forward-mode
    import torch.autograd.forward_ad as fwad

    tl = meshes["1x2x2"].tiling
    rows, cols = tl.tile(FIELD[1:3])
    tile = {k: torch.from_numpy(inp[k][:, rows, cols].copy())
            for k in ("field", "field_g", "field_t")}
    for kh, kw in SHIFTS:
        x = tile["field"].clone().requires_grad_(True)
        y = tl.roll(x, kh, kw)
        (y * tile["field_g"]).sum().backward()
        with fwad.dual_level():
            tangent = fwad.unpack_dual(tl.roll(fwad.make_dual(tile["field"], tile["field_t"]),
                                               kh, kw)).tangent
        res.update({f"roll{kh}_{kw}": y.detach().numpy(), f"rollgrad{kh}_{kw}": x.grad.numpy(),
                    f"rolljvp{kh}_{kw}": tangent.numpy()})

    # the partitioned LGUnet, remat off and on
    net = _configs(tcfg)[0]
    sd = torch.load(d / "net.pt")
    meta["shapes"] = {}
    for arg, mesh in meshes.items():
        for remat in (False, True):
            out, shapes = _net_run(net.replace(remat=remat), sd, inp["x"], inp["g"],
                                   mesh.tiling, mesh.group)
            res.update({f"net.{arg}.{remat}.{k}": v for k, v in out.items()})
            meta["shapes"][f"{arg}.{remat}"] = shapes

    # the VAE train steps
    meta["vae"] = {}
    for arg, mesh in meshes.items():
        out, metrics = _vae_steps(d, inp, mesh)
        res.update({f"vae.{arg}.{k}": v for k, v in out.items()})
        meta["vae"][arg] = metrics

    # the CLI at 1x2x2, trained and resumed: rank 0 writes
    meta["cli"], meta["cli_checksum"] = _cli_runs(d / "cli_mesh", "--mesh", "1x2x2")
    np.savez(d / f"rank{rank}.npz", **res)
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(meta, f)


# --- the parent --------------------------------------------------------------


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _launch(d: Path, n: int) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, __file__, str(d)], cwd=REPO, text=True,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(n)]


def _jax_refs(inp, net_p, flow_p, vae_p):
    """JAX's LGUnet output, input gradient and parameter gradients of
    sum(out * g), and make_vae_train_step's two steps on the global batch."""
    import jax
    import jax.numpy as jnp

    from vaevar_tpu import config as C
    from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
    from vaevar_tpu.models.vae import VAE as JaxVAE
    from vaevar_tpu.train import vae_trainer as jvt
    from vaevar_tpu_torch.utils.port_jax import (lgunet_state_dict_from_flax,
                                                 vae_state_dict_from_flax)

    net, flow_cfg, enc, dec = _configs(C)
    jm = JaxLGUnet(net)
    g = jnp.asarray(inp["g"])

    def value_and_vjp(p, x):
        y, vjp = jax.vjp(jm.apply, p, x)
        return y, vjp(g)

    y, (gp, gx) = jax.jit(value_and_vjp)(net_p, jnp.asarray(inp["x"]))
    out = {"y": np.asarray(y), "xg": np.asarray(gx)}
    out.update({f"grad.{k}": v.numpy() for k, v in lgunet_state_dict_from_flax(
        jax.tree.map(np.asarray, gp), net).items()})

    init_fn, step = jvt.make_vae_train_step(JaxVAE(enc, dec), JaxLGUnet(flow_cfg).apply,
                                            sigma=SIGMA, lr=LR, latent_hw=HW, nmc_steps=NMC)
    params, opt_state = init_fn(None, None, None, params=vae_p)
    step_j = jax.jit(step)
    metrics, states = [], []
    for k in range(2):
        params, opt_state, m = step_j(params, opt_state, flow_p, jnp.asarray(inp[f"frames{k}"]),
                                      jax.random.PRNGKey(20 + k))
        metrics.append({key: float(v) for key, v in m.items()})
        states.append({key: v.numpy() for key, v in vae_state_dict_from_flax(
            jax.tree.map(np.asarray, params), enc, dec).items()})
        if k == 0:  # Adam's first moment after one update is (1 - b1) g
            grads = {key: v.numpy() for key, v in vae_state_dict_from_flax(
                jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), opt_state[0].mu),
                enc, dec).items()}
    return out, dict(metrics=metrics, states=states, grads=grads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from torch_port_util import flax_params
    from vaevar_tpu import config as C
    from vaevar_tpu.models.vae import VAE as JaxVAE
    from vaevar_tpu.utils.fast_init import fast_init as jax_fast_init
    from vaevar_tpu_torch.train import checkpoint as tckpt
    from vaevar_tpu_torch.utils.port_jax import (lgunet_state_dict_from_flax,
                                                 vae_state_dict_from_flax)

    d = tmp_path_factory.mktemp("spatial")
    net, flow_cfg, enc, dec = _configs(C)
    net_p, flow_p = flax_params(net, seed=1), flax_params(flow_cfg, seed=2)
    vae_p = jax.tree.map(np.asarray, jax_fast_init(
        JaxVAE(enc, dec), jnp.zeros((1, NC, *HW), jnp.float32), jax.random.PRNGKey(0), seed=3))
    torch.save(lgunet_state_dict_from_flax(net_p, net), d / "net.pt")
    torch.save(lgunet_state_dict_from_flax(flow_p, flow_cfg), d / "flow.pt")
    torch.save(vae_state_dict_from_flax(vae_p, enc, dec), d / "vae.pt")
    inp = _inputs()
    for k in range(2):  # JAX's noise of the global latent for each step's key
        inp[f"eps{k}"] = np.asarray(jax.random.normal(jax.random.PRNGKey(20 + k),
                                                      (2, 8, *HW), jnp.float32))
    np.savez(d / "inputs.npz", **inp)

    procs = _launch(d, 4)
    try:
        torch.set_num_threads(1)
        single = {}
        for remat in (False, True):
            single[remat] = _net_run(net.replace(remat=remat), torch.load(d / "net.pt"),
                                     inp["x"], inp["g"])[0]
        jax_net, jax_vae = _jax_refs(inp, net_p, flow_p, vae_p)
        single_vae = _vae_steps(d, inp)[0]
        cli_single = _cli_runs(d / "cli_single")[0]
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}\n{e[-6000:]}"
    return dict(inputs=inp, single=single, jax_net=jax_net, jax_vae=jax_vae,
                single_vae=single_vae,
                cli_single=cli_single,
                cli_single_state=tckpt.restore(str(d / "cli_single" / "vae_epoch0")),
                cli_mesh_state=tckpt.restore(str(d / "cli_mesh" / "vae_epoch0")),
                cli_log=open(d / "cli_mesh" / "run.log").read(),
                ranks=[dict(np.load(d / f"rank{r}.npz")) for r in range(4)],
                meta=[json.load(open(d / f"rank{r}.json")) for r in range(4)])


def _assemble(parts, coords, sh, sw, dims=(-2, -1)):
    """The whole field from the tiles of the ranks of dp index 0, its
    (lat, lon) axes `dims`."""
    rows = [[None] * sw for _ in range(sh)]
    for part, c in zip(parts, coords):
        if c["dp"] == 0:
            rows[c["sh"]][c["sw"]] = part
    return np.concatenate([np.concatenate(r, dims[1]) for r in rows], dims[0])


def _axes(arg):
    return tuple(int(v) for v in arg.split("x"))


# --- the halo shift ----------------------------------------------------------


@pytest.mark.parametrize("shift", SHIFTS)
def test_halo_roll_equals_torch_roll_bitwise(world, shift):
    """Forward, backward (the roll by -k of the cotangent) and forward-mode,
    each assembled from the 4 tiles, against torch.roll of the whole."""
    kh, kw = shift
    inp = world["inputs"]
    coords = [m["coords"]["1x2x2"] for m in world["meta"]]
    for key, src, sign in (("roll", "field", 1), ("rollgrad", "field_g", -1),
                           ("rolljvp", "field_t", 1)):
        got = _assemble([r[f"{key}{kh}_{kw}"] for r in world["ranks"]], coords, 2, 2, (1, 2))
        want = torch.roll(torch.from_numpy(inp[src]), (sign * kh, sign * kw), (1, 2)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


# --- the partitioned LGUnet ---------------------------------------------------


def _net_whole(world, arg, remat):
    dp, sh, sw = _axes(arg)
    coords = [m["coords"][arg] for m in world["meta"]]
    ranks = world["ranks"]
    out = {k: _assemble([r[f"net.{arg}.{remat}.{k}"] for r in ranks], coords, sh, sw)
           for k in ("y", "xg")}
    out.update({k[len(f"net.{arg}.{remat}."):]: ranks[0][k] for k in ranks[0]
                if k.startswith(f"net.{arg}.{remat}.grad.")})
    return out


def _check_net(got, want):
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-4, atol=1e-5)
    for k in want:
        if k == "y":
            continue
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * scale, err_msg=k)


@pytest.mark.parametrize("arg", MESHES)
@pytest.mark.parametrize("remat", [False, True])
def test_partitioned_lgunet_equals_one_process(world, arg, remat):
    _check_net(_net_whole(world, arg, remat), world["single"][remat])


@pytest.mark.parametrize("arg", MESHES)
@pytest.mark.parametrize("remat", [False, True])
def test_partitioned_lgunet_equals_jax(world, arg, remat):
    got = _net_whole(world, arg, remat)
    assert sorted(got) == sorted(world["jax_net"])
    _check_net(got, world["jax_net"])


@pytest.mark.parametrize("arg", MESHES)
def test_each_rank_holds_only_its_tile(world, arg):
    """The patch embed's output (B, h, w, C) and the LG stage's are this
    rank's tile of the 16x32 and 8x16 grids, never the whole; and the
    shifted windows exchanged halos: 9 shifted blocks (2 groups x 2 levels
    in the encoder and the decoder, 1 in the LG stage) x 2 rolls x a split
    axis, forward and backward, and again in the remat's recompute."""
    _, sh, sw = _axes(arg)
    axes = (sh > 1) + (sw > 1)
    for m in world["meta"]:
        for remat in (False, True):
            got = m["shapes"][f"{arg}.{remat}"]
            assert got["patch_embed"] == [2, 16 // sh, 32 // sw, 4]
            assert got["lg_stage"] == [2, 8 // sh, 16 // sw, 16]
        assert m["shapes"][f"{arg}.False"]["halos"] == 9 * 2 * axes * 2
        assert m["shapes"][f"{arg}.True"]["halos"] == 9 * 2 * axes * 3


# --- the VAE steps -----------------------------------------------------------


@pytest.mark.parametrize("arg", MESHES)
def test_vae_steps_equal_jax_global_step(world, arg):
    want = world["jax_vae"]
    ranks = world["ranks"]
    for r, m in enumerate(world["meta"]):
        for got, ref in zip(m["vae"][arg], want["metrics"]):
            for k in ("loss", "rec_sse", "kld"):
                assert got[k] == pytest.approx(ref[k], rel=1e-5), (r, k)
    pre = f"vae.{arg}."
    scale = max(np.abs(g).max() for g in want["grads"].values())
    assert sorted(k[len(pre + "vgrad."):] for k in ranks[0] if k.startswith(pre + "vgrad.")) \
        == sorted(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(ranks[0][f"{pre}vgrad.{k}"], g, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    for s, state in enumerate(want["states"]):
        for k, v in state.items():
            np.testing.assert_allclose(ranks[0][f"{pre}state{s}.{k}"], v, rtol=0, atol=2.5 * LR,
                                       err_msg=k)


@pytest.mark.parametrize("arg", MESHES)
def test_error_sample_resized_on_the_tiles(world, arg):
    """nmc_error_sample on a latent grid of half the frames' (the tiles
    gathered, then the tile of the nearest resize) against one process's
    tile of the whole: rtol 1e-5, atol 1e-6 (the partitioned flow model's
    f32 sums in other orders)."""
    dp, sh, sw = _axes(arg)
    for r, m in enumerate(world["meta"]):
        c = m["coords"][arg]
        h, w = LATENT_HALF[0] // sh, LATENT_HALF[1] // sw
        b = 2 // dp
        want = world["single_vae"]["err_half"][c["dp"] * b:(c["dp"] + 1) * b, :,
                                               c["sh"] * h:(c["sh"] + 1) * h,
                                               c["sw"] * w:(c["sw"] + 1) * w]
        got = world["ranks"][r][f"vae.{arg}.err_half"]
        assert got.shape == want.shape == (b, NC, h, w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("rows, tile", [((0, 2), (slice(16, 32), slice(0, 32))),
                                        ((1, 2), (slice(0, 8), slice(48, 64)))])
def test_noise_tile_is_the_slice_of_jax_draw(rows, tile):
    """A rank's rows and (lat, lon) tile of the global latent draw
    (utils/jax_random.py `rows=`, `tile=`): bitwise the port's whole draw's
    slice, and within 4 ulp of max(|x|, 1) of jax.random.normal's (as
    tests/test_torch_vae_train.py's draws)."""
    import jax
    import jax.numpy as jnp

    from vaevar_tpu_torch.utils import jax_random as tjr

    shape = (2, 8, *HW)
    kt, kj = tjr.fold_in(tjr.prng_key(5), 3), jax.random.fold_in(jax.random.PRNGKey(5), 3)
    got = tjr.normal(kt, shape, rows=rows, tile=tile).numpy()
    whole = tjr.normal(kt, shape).numpy()[rows[0]:rows[1], :, tile[0], tile[1]]
    np.testing.assert_array_equal(got, whole)
    want = np.asarray(jax.random.normal(kj, shape, jnp.float32))[rows[0]:rows[1], :, tile[0],
                                                                 tile[1]]
    assert (np.abs(got - want) <= 4 * np.spacing(np.maximum(np.abs(want), 1))).all()


def test_ranks_agree_bitwise(world):
    ranks, meta = world["ranks"], world["meta"]
    for k in ranks[0]:
        if k.startswith(("net.", "vae.")) and not k.endswith((".y", ".xg", ".err_half")):
            for r in range(1, 4):
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")
    for key in ("vae", "cli", "cli_checksum"):
        assert all(m[key] == meta[0][key] for m in meta), key


def test_mesh_layout_is_jax_row_major(world):
    for r, m in enumerate(world["meta"]):
        assert m["rank"] == r
        assert m["coords"]["1x2x2"] == {"dp": 0, "sh": r // 2, "sw": r % 2}
        assert m["coords"]["2x1x2"] == {"dp": r // 2, "sh": 0, "sw": r % 2}


# --- the CLI -----------------------------------------------------------------


def test_cli_mesh_1x2x2_equals_one_process(world):
    """Trained one epoch (its losses and weights), then resumed for a
    second (its losses) from the checkpoint rank 0 wrote."""
    log = world["cli_log"]
    assert "mesh: dp 1 x sh 2 x sw 2, rank 0 on cpu (gloo)" in log and "resumed from" in log
    got, want = world["meta"][0]["cli"], world["cli_single"]
    assert [len(g) for g in got] == [len(w) for w in want] == [2, 2]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    a, b = world["cli_mesh_state"], world["cli_single_state"]
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=2.5 * LR, err_msg=k)


# --- what is refused ---------------------------------------------------------


def _refusal_cases():
    from vaevar_tpu import config as C

    micro16 = C.micro_vae_configs(img_size=(16, 32))[1]
    return {
        # the 4x8 LG grid clamps its window to 4x4: one window row for 2 ranks
        "windows_cut": (micro16, (2, 1), "has 1 row of 4x4 windows for the 2 ranks"),
        # the rope model's 8x16 level has 4 window columns for 8 ranks (its
        # full-grid LG stage runs whole, tests/test_torch_spatial_forecast.py)
        "full_grid_stage": (C.micro_config(img_size=HW), (1, 8),
                            "has 4 columns of 4x4 windows for the 8 ranks"),
        "general_path": (C.micro_config(img_size=HW, lg_full_attn_first=False,
                                        window_size=(4, 4), dilated_size=(1, 2)),
                         (1, 2), "general path"),
        "uneven_tile": (C.micro_vae_configs(img_size=(32, 64))[1], (3, 1),
                        "does not divide over the mesh axis sh=3"),
    }


@pytest.mark.parametrize("case", ["windows_cut", "full_grid_stage", "general_path",
                                  "uneven_tile"])
def test_partition_refuses_what_the_forecast_half_takes(case):
    """Each raises ValueError (never runs replicated) and names the level,
    the grid, the window and the mesh, or the dim and the axis."""
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel.spatial import Tiling

    cfg, (sh, sw), match = _refusal_cases()[case]
    model = LGUnet(cfg)
    with pytest.raises(ValueError, match=match) as err:
        model.partition(Tiling(sh, sw))
    if case == "windows_cut":
        assert "enc.enc_list.0.layers.1, level 1: its 4x8 grid" in str(err.value)
    if case == "full_grid_stage":
        assert "enc.enc_list.0.layers.1, level 1: its 8x16 grid" in str(err.value)
    if case != "uneven_tile":
        assert "mesh sh=" in str(err.value)
    # a refused model is left as it was: no module partitioned, no mask cut
    fresh = LGUnet(cfg)
    assert model._tiling is None
    for (name, m), f in zip(model.named_modules(), fresh.modules()):
        assert getattr(m, "tiling", None) is None, name
        if getattr(f, "mask", None) is not None:
            assert torch.equal(m.mask, f.mask), name


def test_partition_refuses_a_kernel_over_its_stride_and_tensor_parallel():
    """FORECAST_025's lat kernel 3 at stride 2 at sh > 1 (its lon kernel 2
    at sw > 1 is local), and a tensor-parallel model."""
    from vaevar_tpu import config as C
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import tensor_parallel as tp
    from vaevar_tpu_torch.parallel.spatial import Tiling

    cfg = C.micro_vae_configs(img_size=(32, 64))[1].replace(patch_size=(3, 2))
    with pytest.raises(ValueError, match="kernel 3, stride 2 along lat"):
        LGUnet(cfg).partition(Tiling(2, 1))
    LGUnet(cfg).partition(Tiling(1, 2))  # lon: kernel 2 == stride 2
    model = LGUnet(C.micro_vae_configs(img_size=HW)[1])
    blk = model.net.layers[0].blocks[0]
    blk.mlp = tp._RowParallel(blk.mlp, "hidden", "fc2", None, 64, 32)
    with pytest.raises(ValueError, match="tensor-parallel"):
        model.partition(Tiling(1, 2))


def test_forecast_trainer_refuses_a_spatial_mesh():
    """make_forecast_train_step on a TrainMesh partitions the rope model
    with its full-grid LG stage (run whole on every rank) and refuses only
    a mesh that cannot tile it: ValueError, the model left whole."""
    from vaevar_tpu import config as C
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.train import forecast_trainer as ft

    model = LGUnet(C.micro_config(img_size=HW))
    mesh = pmesh.TrainMesh(1, 1, 2, rank=1)
    ft.make_forecast_train_step(model, mesh=mesh, out_shape=(138, *HW))
    assert model._tiling == mesh.tiling and model.net.layout.cols == (8, 8)
    model = LGUnet(C.micro_config(img_size=HW))
    with pytest.raises(ValueError, match="4 columns of 4x4 windows for the 8 ranks"):
        ft.make_forecast_train_step(model, mesh=pmesh.TrainMesh(1, 1, 8))
    assert model._tiling is None


def test_train_mesh_parse_and_launch_checks(monkeypatch):
    """DPxSHxSW parses to (dp, sh, sw), DP to (dp, 1, 1); malformed meshes
    raise ValueError; outside a launch a mesh of more than one process
    raises; 1x1x1 is one process as a DPMesh."""
    from vaevar_tpu_torch.parallel import mesh as pmesh

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "SLURM_NTASKS",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.parse_train_mesh("2x1x4") == (2, 1, 4)
    assert pmesh.parse_train_mesh("4") == (4, 1, 1)
    for bad in ("2x2", "0x1x2", "2x2x2x2", "ax1x1"):
        with pytest.raises(ValueError, match="DPxSHxSW"):
            pmesh.mesh_from_arg(bad, "cpu")
    with pytest.raises(RuntimeError, match="needs 4 processes"):
        pmesh.mesh_from_arg("1x2x2", "cpu")
    assert pmesh.mesh_from_arg("1x1x1", "cpu") == pmesh.DPMesh(1, 0, torch.device("cpu"))
    assert pmesh.TrainMesh(2, 2, 2, rank=5).coords == {"dp": 1, "sh": 0, "sw": 1}
    assert pmesh.TrainMesh(2, 2, 2, rank=5).batch_spec(3) == (3, 6)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
