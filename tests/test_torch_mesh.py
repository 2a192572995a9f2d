"""The spatially partitioned solve (run_da --mesh SHxSW), and the same with
tensor-parallel ranks (TPxSHxSW), against the port's single-process solve
and JAX's sharded one.

The setup is tests/test_sharded_da.py's micro one: 32x64, the micro VAE
decoder (latent (1, 8, 32, 64)), free_0005 obs of a perturbed background,
R from obs_std 0.1, L-BFGS 4 iterations, nit 1; the window cases add the
micro flow model and a second slot (da_win 2), the real-obs case the 204
observation-level channels of 40 levels at 2 % station columns. The
weights come from JAX's fast_init through the bridge, so both packages
solve with the same models.

Four gloo ranks in subprocesses on the CPU, one torch thread each (this file
is also the worker: `python tests/test_torch_mesh.py <dir>` with torchrun's
environment), form a 2x2 mesh, each holding its tile of yo, H (and of a full
R) by JAX's rule. While they run, this process solves the same problems
without a mesh and JAX solves them on a 2x2 mesh of its CPU devices. Then
four more ranks form a tp x sh x sw mesh of 2x1x2 (`python
tests/test_torch_mesh.py <dir> 2x1x2`): the decoder placed by
shard_tensor_parallel over each tile's 2 tp ranks (its 1-head LG stage
keeps its attention whole, its MLP splits), the obs tiled over sw; they
solve the reduced and the full cost (the full one with zoom and with
jvp-zoom) against the single process and JAX's VariationalSolver on a
{"tp": 2, "sh": 1, "sw": 2} mesh with its shard_tensor_parallel on the
decoder. The 2x2x2 mesh (8 ranks) against JAX's is in the slow tier, as
JAX's own (tests/test_sharded_da.py:256-300).

Tolerances:
- `tile_for` equals JAX's NamedSharding placement exactly (spec,
  shard_shape and every device's indices), and a tile-restricted nearest
  resize is the slice of the whole one bit for bit.
- The tiled reductions (partial sums over each tile, summed over the ranks)
  equal the single-process ones at rtol 1e-5 (and ybar at atol 1e-6 x
  (|mean| + std), as tests/test_torch_window.py): the same f32 sums in
  another order. The tiled obs term, J, its gradient and jvp slope through
  the copy/sum pair: rtol 1e-5 (gradient atol 1e-5 x max|grad|).
- The solves: equal iteration and eval counts, and the analysis increments
  within norm-relative 1e-3 of the single-process port solve and of JAX's
  sharded solve (JAX's own bound, tests/test_sharded_da.py:93-100; observed
  values are printed with -s). JAX's window solves are in the slow tier:
  each compiles for 40-50 s on the CPU, which would take the file past its
  ~60 s budget.
- The ranks' controls and analyses: bitwise equal (tp x sh x sw: every
  number, on every rank).
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
LATENT = (1, 8, *HW)
MESH = (2, 2)
ITERS = 4
SOLVES = ("full", "reduced", "window", "realwin")
JAX_FAST = ("full", "reduced")  # JAX's window solves compile for 40-50 s each
TP_SOLVES = ("full", "reduced")  # and full_jvp
TP_AXES = {"tp": 2, "sh": 1, "sw": 2}


def _configs(C):
    """The micro VAE decoder and the micro flow model of
    tests/test_sharded_da.py."""
    return (C.micro_config(img_size=HW, inchans_list=(2, 6), outchans_list=(13, 56)),
            C.micro_config(img_size=HW))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# --- the port's problems, on one process or on a rank ------------------------


def _port_problems(d: Path, mesh=None):
    """{name: (cost, to_state, parts, bundle)} of the four solves on the
    port, and the models, from the inputs the parent wrote to `d`; with a
    `mesh`, the reductions are this rank's tiles summed over the ranks."""
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.da import cost as tcost
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.parallel.mesh import shard, shard_tensor_parallel

    dec_cfg, flow_cfg = _configs(tcfg)
    models = {}
    for name, cfg in (("decoder", dec_cfg), ("flow", flow_cfg)):
        m = LGUnet(cfg)
        m.load_state_dict(torch.load(d / f"{name}.pt"), strict=True)
        models[name] = m.eval().requires_grad_(False)
    if mesh is not None:  # a tp x sh x sw mesh splits the decoder (tp 1: nothing)
        shard_tensor_parallel(models["decoder"], mesh)
    dec, flow = models["decoder"], models["flow"]
    inp = {k: torch.from_numpy(v) for k, v in np.load(d / "inputs.npz").items()}
    b1 = tcost.ObsBundle(inp["xb"], inp["yo"], inp["H"], inp["R"])
    b2 = tcost.ObsBundle(inp["xb"], inp["yo2"], inp["H2"], inp["R2"])
    b3 = tcost.ObsBundle(inp["xb"], inp["yo3"], inp["H3"], inp["R3"])
    tiles = (lambda b: b) if mesh is None else (lambda b: b._replace(
        **{k: shard(getattr(b, k), mesh) for k in ("yo", "H", "R")}))
    return {
        "full": (*tcost.make_vae4dvar_cost(dec, mesh=mesh), tiles(b1)),
        "reduced": (*tcost.make_vae4dvar_cost_reduced(dec),
                    tcost.reduce_obs(tiles(b1), HW, mesh=mesh)),
        "window": (*tcost.make_vae4dvar_cost_window_reduced(dec, flow, da_win=2),
                   tcost.reduce_obs_window(tiles(b2), HW, mesh=mesh)),
        "realwin": (*tcost.make_vae4dvar_cost(dec, flow, flow_hw=HW, da_win=2,
                                              interp_matrix=inp["interp"].numpy(), mesh=mesh),
                    tiles(b3)),
    }, inp


def _port_results(d: Path, mesh=None, solves=SOLVES) -> dict:
    """Every number the tests compare, from one process or one rank, for
    the problems `solves`."""
    from vaevar_tpu_torch.da import cost as tcost
    from vaevar_tpu_torch.da.lbfgs import value_and_slope
    from vaevar_tpu_torch.da.solver import VariationalSolver
    from vaevar_tpu_torch.parallel.mesh import shard

    problems, inp = _port_problems(d, mesh)
    out = {}
    red, redw = problems["reduced"][3], problems["window"][3]
    out.update(red_a=red.a, red_b=red.b, red_c=red.c, redw_a=redw.a, redw_ybar=redw.ybar,
               redw_c=redw.c, redw_xb_low=redw.xb_low)
    b1 = problems["full"][3]
    # the obs term of a prediction, with R materialized to the whole grid
    # (so that it is tiled too), and level-augmented
    x_pred = 0.9 * inp["yo"]
    full_r = b1._replace(R=torch.broadcast_to(inp["R"], inp["yo"].shape).contiguous())
    if mesh is not None:
        full_r = full_r._replace(R=shard(full_r.R, mesh))
        x_pred = shard(x_pred, mesh)
    out["obs_term"] = tcost.obs_term(x_pred, full_r, mesh=mesh)
    z, u = inp["z_probe"], inp["u_probe"]
    for name in [n for n in ("full", "realwin") if n in solves]:
        cost, _, _, bundle = problems[name]
        x = z.clone().requires_grad_(True)
        J = cost(x, bundle)
        (g,) = torch.autograd.grad(J, x)
        _, slope = value_and_slope(lambda q: cost(q, bundle), z, u)
        out.update({f"{name}_J": J.detach(), f"{name}_g": g, f"{name}_slope": slope})
    z0 = torch.zeros(LATENT)
    runs = [(name, name, "zoom") for name in solves] + [("full_jvp", "full", "jvp-zoom")]
    for key, name, ls in runs:
        cost, to_state, parts, bundle = problems[name]
        solver = VariationalSolver(cost, to_state, parts, lbfgs_iters=ITERS, linesearch=ls)
        zs, xa, diag = solver.solve(z0, bundle, nit=1, gt=inp["gt"][None], verbose=False)
        out.update({f"{key}_z": zs, f"{key}_xa": xa,
                    f"{key}_counts": torch.tensor([diag.n_iters, diag.n_evals]),
                    f"{key}_jbjo": torch.tensor([diag.loss_reg, diag.loss_obs],
                                                dtype=torch.float64)})
        if key == "full":
            out["full_yo_shape"] = torch.tensor(bundle.yo.shape)
    return {k: v.detach().numpy() for k, v in out.items()}


def _worker(d: Path):
    torch.set_num_threads(1)
    from vaevar_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.init_distributed(backend="gloo", device="cpu")
    # run_da's own call after a caller set up gloo: the group is kept
    again = pmesh.init_distributed(device="cuda")
    mesh = pmesh.spatial_mesh_from_arg(f"{MESH[0]}x{MESH[1]}", "cpu")
    out = _port_results(d, mesh)
    # host_value gathers the tiles of a whole field
    full = np.load(d / "inputs.npz")["yo3"]
    tile = pmesh.shard(torch.from_numpy(full), mesh)
    gathered = pmesh.host_value(tile, mesh, HW)
    meta = {"rank": rank, "again": again, "mesh": [mesh.sh, mesh.sw, mesh.rank],
            "tile_shape": list(tile.shape), "gathered": bool(np.array_equal(gathered, full)),
            "digest": pmesh.digest(*(torch.from_numpy(out[f"{s}_{k}"])
                                     for s in (*SOLVES, "full_jvp") for k in ("z", "xa")))}
    try:
        pmesh.check_replicas(pmesh.digest(torch.tensor([float(rank)])))
    except RuntimeError as e:
        meta["drift"] = str(e)
    np.savez(d / f"rank{rank}.npz", **out)
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(meta, f)
    torch.distributed.destroy_process_group()


def _tp_worker(d: Path, arg: str):
    """One rank of a tp x sh x sw mesh `arg`: the TP_SOLVES problems with
    the decoder placed over the rank's tp group."""
    torch.set_num_threads(1)
    from vaevar_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.init_distributed(backend="gloo", device="cpu")
    out = _port_results(d, pmesh.spatial_mesh_from_arg(arg, "cpu"), TP_SOLVES)
    np.savez(d / f"{arg}.rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


# --- the parent: inputs, the single-process port, JAX ------------------------


def _inputs():
    """tests/test_sharded_da.py's micro bundles as numpy: 3D-Var, the da_win
    2 window, and the da_win 2 real-obs augmented window."""
    import jax.numpy as jnp

    from vaevar_tpu.da import obs as jobs
    from vaevar_tpu.ops.interp import augment_levels, obs_level_interp_matrix

    rr = np.random.default_rng(3)
    xb = rr.normal(size=(69, *HW)).astype(np.float32)
    gt = xb + np.float32(0.3) * rr.normal(size=(69, *HW)).astype(np.float32)
    H = jobs.make_obs_mask("free_0005", 1, HW, rr).astype(np.float32)
    R = jobs.build_R(jobs.obs_error_variance(0.1), None, 1, HW)
    rr = np.random.default_rng(9)
    yo2 = np.concatenate([gt[None], gt[None] + np.float32(0.1) * rr.normal(
        size=(1, 69, *HW)).astype(np.float32)])
    H2 = jobs.make_obs_mask("free_0005", 2, HW, rr).astype(np.float32)
    R2 = jobs.build_R(jobs.obs_error_variance(0.1), None, 2, HW)
    interp = np.asarray(obs_level_interp_matrix(40), np.float32)
    rr = np.random.default_rng(11)
    gt_aug = np.asarray(augment_levels(jnp.asarray(np.stack([gt, gt + np.float32(0.05)])),
                                       jnp.asarray(interp)))
    cols = rr.random((1, 1, *HW)) < 0.02
    lvl = rr.random((2, gt_aug.shape[1], 1, 1)) < 0.6
    H3 = np.broadcast_to((cols & lvl).astype(np.float32), gt_aug.shape).copy()
    R3 = np.asarray(augment_levels(jnp.asarray(R2), jnp.asarray(interp)))
    rr = np.random.default_rng(13)
    return dict(xb=xb, gt=gt, yo=gt[None], H=H, R=R, yo2=yo2, H2=H2, R2=R2, interp=interp,
                yo3=gt_aug * H3, H3=H3, R3=R3,
                z_probe=(0.1 * rr.standard_normal(LATENT)).astype(np.float32),
                u_probe=rr.standard_normal(LATENT).astype(np.float32))


def _jax_solves(inputs, dec_params, flow_params, names, axes=None) -> dict:
    """JAX's VariationalSolver on a mesh of its CPU devices (`axes`, the
    2x2 {"sh", "sw"} mesh by default; with a "tp" axis the decoder placed by
    its shard_tensor_parallel), for the problems `names`: {name:
    analysis}."""
    import jax
    import jax.numpy as jnp

    from vaevar_tpu import config as C
    from vaevar_tpu.da import cost as jcost
    from vaevar_tpu.da.solver import VariationalSolver
    from vaevar_tpu.models.lgunet import LGUnet
    from vaevar_tpu.parallel import mesh as jmesh

    dec_cfg, flow_cfg = _configs(C)
    dec, flow = LGUnet(dec_cfg), LGUnet(flow_cfg)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    b1 = jcost.ObsBundle(j["xb"], j["yo"], j["H"], j["R"])
    b2 = jcost.ObsBundle(j["xb"], j["yo2"], j["H2"], j["R2"])
    b3 = jcost.ObsBundle(j["xb"], j["yo3"], j["H3"], j["R3"])
    problems = {
        "full": lambda: (jcost.make_vae4dvar_cost(dec.apply), b1),
        "reduced": lambda: (jcost.make_vae4dvar_cost_reduced(dec.apply),
                            jcost.reduce_obs(b1, HW)),
        "window": lambda: (jcost.make_vae4dvar_cost_window_reduced(dec.apply, flow.apply,
                                                                   da_win=2),
                           jcost.reduce_obs_window(b2, HW)),
        "realwin": lambda: (jcost.make_vae4dvar_cost(dec.apply, flow.apply, flow_hw=HW,
                                                     da_win=2, interp_matrix=j["interp"]), b3),
    }
    axes = axes or {"sh": MESH[0], "sw": MESH[1]}
    mesh = jmesh.make_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    if "tp" in axes:
        dec_params = jmesh.shard_tensor_parallel(dec_params, mesh)
    params = {"decoder": dec_params, "flow": flow_params}
    out = {}
    for name in names:
        (cost, to_state, parts), bundle = problems[name]()
        solver = VariationalSolver(cost, to_state, parts, lbfgs_iters=ITERS, mesh=mesh)
        _, xa, _ = solver.solve(jnp.zeros(LATENT, jnp.float32), bundle, params, nit=1,
                                verbose=False)
        out[name] = np.asarray(xa)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from torch_port_util import model_pair
    from vaevar_tpu import config as C

    d = tmp_path_factory.mktemp("mesh")
    dec_cfg, flow_cfg = _configs(C)
    _, dec_params, tdec = model_pair(dec_cfg, seed=0)
    _, flow_params, tflow = model_pair(flow_cfg, seed=5)
    torch.save(tdec.state_dict(), d / "decoder.pt")
    torch.save(tflow.state_dict(), d / "flow.pt")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)

    n = MESH[0] * MESH[1]
    procs = _launch(d, n)
    try:
        torch.set_num_threads(1)
        single = _port_results(d)
        jax_xa = _jax_solves(inputs, dec_params, flow_params, JAX_FAST)
        _wait(procs)
    finally:
        for p in procs:
            p.kill()
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
    meta = [json.load(open(d / f"rank{r}.json")) for r in range(n)]
    return dict(inputs=inputs, single=single, jax=jax_xa, ranks=ranks, meta=meta,
                params=(dec_params, flow_params), dir=d)


def _launch(d: Path, n: int, *args) -> list:
    """n gloo ranks of this file as workers on `d` (`args`: a tp x sh x sw
    mesh), with torchrun's environment and a free port."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, __file__, str(d), *args], cwd=REPO, text=True,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(n)]


def _wait(procs):
    logs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}\n{e[-6000:]}"


def _tp_run(world, axes) -> dict:
    """The TP_SOLVES on the ranks of a tp x sh x sw mesh `axes`, and JAX's
    on the same mesh of its devices, run meanwhile."""
    arg = "x".join(str(axes[a]) for a in ("tp", "sh", "sw"))
    n = int(np.prod(list(axes.values())))
    procs = _launch(world["dir"], n, arg)
    try:
        jax_xa = _jax_solves(world["inputs"], *world["params"], TP_SOLVES, axes)
        _wait(procs)
    finally:
        for p in procs:
            p.kill()
    return dict(jax=jax_xa, ranks=[dict(np.load(world["dir"] / f"{arg}.rank{r}.npz"))
                                   for r in range(n)])


@pytest.fixture(scope="module")
def tp_world(world):
    return _tp_run(world, TP_AXES)


# --- the tiling rule ---------------------------------------------------------

TILE_CASES = [((2, 4), s) for s in ((69, 128, 256), (69, 721, 1440), (16, 721), (7, 103),
                                    (3, 721, 1440))] + \
             [(m, (69, 721, 1440)) for m in ((1, 2), (2, 2))] + [((2, 2), (69, 32, 64))]


@pytest.mark.parametrize("mesh_shape, shape", TILE_CASES)
def test_tile_for_equals_jax_state_spec_and_placement(mesh_shape, shape):
    """tests/test_sharded_da.py:58-79's shapes on its 2x4 mesh, and the
    0.25 deg field on 1x2 and 2x2 (lon halves or quarters: 721 rows divide
    by neither): the spec, the tile's shape and every rank's rows and
    columns are those JAX places on the device of that rank."""
    import jax
    from jax.sharding import NamedSharding

    from vaevar_tpu.parallel import mesh as jmesh
    from vaevar_tpu_torch.parallel import mesh as tmesh

    sh, sw = mesh_shape
    jm = jmesh.make_mesh({"sh": sh, "sw": sw}, jax.devices()[:sh * sw])
    spec = jmesh.state_spec_for(jm, shape)
    sharding = NamedSharding(jm, spec)
    placed = sharding.devices_indices_map(shape)
    for r, dev in enumerate(jm.devices.flat):
        m = tmesh.SpatialMesh(sh, sw, r)
        assert tmesh.state_spec_for(m, shape) == tuple(spec)
        tile = tmesh.tile_for(m, shape)
        want = [slice(*s.indices(n)[:2]) for s, n in zip(placed[dev][-2:], shape[-2:])]
        assert [tile.rows, tile.cols] == want, (r, tile, want)
        field = np.broadcast_to(np.float32(0), shape)  # no memory behind it
        assert tmesh.shard(field, m).shape == (
            sharding.shard_shape(shape) if tmesh.is_full(field) else shape)
    # the ranks holding one tile: only the first adds its sums
    tiles = {}
    for r in range(sh * sw):
        t = tmesh.tile_for(tmesh.SpatialMesh(sh, sw, r), shape)
        tiles.setdefault((t.rows, t.cols), []).append(t.primary)
    assert all(p.count(True) == 1 for p in tiles.values())


@pytest.mark.parametrize("src, out", [((16, 32), (721, 1440)), ((32, 64), (32, 64)),
                                      ((128, 256), (47, 93))])
def test_resize_nearest_on_a_tile_is_the_slice(src, out):
    from vaevar_tpu_torch.ops.interp import _nearest_idx, resize_nearest
    from vaevar_tpu_torch.parallel import mesh as tmesh

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, *src)).astype(np.float32))
    whole = resize_nearest(x, out)
    for sh, sw in ((1, 2), (2, 2), (2, 4)):
        for r in range(sh * sw):
            tile = tmesh.tile_for(tmesh.SpatialMesh(sh, sw, r), (3, *out))
            got = resize_nearest(x, out, tile)
            assert torch.equal(got, whole[..., tile.rows, tile.cols])
            np.testing.assert_array_equal(_nearest_idx(out[1], src[1])[tile.cols],
                                          np.minimum(np.arange(out[1])[tile.cols] * src[1]
                                                     // out[1], src[1] - 1))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (2, 4), (4, 2), (1, 8)])
def test_obs_holdout_error_sums_every_tile_of_the_grid(monkeypatch, mesh_shape):
    """The cycler's error_obs at 721x1440 (2x2 and up fold both axes onto
    lon, 721 rows dividing by nothing): each rank's numerator and
    denominator over its tiles of the analysis, yo, H and the eval mask,
    summed over the ranks, equal the single process's error at rtol 1e-5
    (the same f32 sums in another order), on every rank. The ranks are
    simulated one after another: the all-reduce returns the sum of what
    every rank handed it."""
    from types import SimpleNamespace

    from vaevar_tpu_torch.da.cycler import CycledDA
    from vaevar_tpu_torch.parallel import mesh as tmesh

    hw = (721, 1440)
    rng = np.random.default_rng(5)
    xa = torch.from_numpy(rng.standard_normal((3, *hw)).astype(np.float32))
    yo = (xa + 0.1 * torch.from_numpy(rng.standard_normal((3, *hw)).astype(np.float32)))
    H = torch.from_numpy((rng.random((3, *hw)) < 0.05).astype(np.float32))
    mask_eval = (rng.random((3, *hw)) < 0.2).astype(np.float32)

    def error(mesh):
        da = object.__new__(CycledDA)  # the fields the method reads, no models
        da.__dict__.update(cfg=SimpleNamespace(grid_hw=hw), mesh=mesh, is_real_obs=False,
                           _interp=None, mask_eval=mask_eval, _mask_eval_t=None, device="cpu")
        return da._obs_holdout_error(xa, tmesh.shard(yo, mesh), tmesh.shard(H, mesh))

    want = error(None)
    sh, sw = mesh_shape
    handed = []
    monkeypatch.setattr(tmesh, "all_sum", lambda t: handed.append(t.clone()) or t)
    for r in range(sh * sw):
        error(tmesh.SpatialMesh(sh, sw, r))
    total = torch.stack(handed).sum(0)
    monkeypatch.setattr(tmesh, "all_sum", lambda t: total.clone())
    for r in range(sh * sw):
        np.testing.assert_allclose(error(tmesh.SpatialMesh(sh, sw, r)), want, rtol=1e-5,
                                   err_msg=f"rank {r} of {sh}x{sw}")


def test_spatial_mesh_from_arg_checks_the_launch(monkeypatch):
    """Outside a launch of TP*SH*SW processes --mesh SHxSW and TPxSHxSW
    raise; TPxSHxSW parses to (tp, sh, sw), SHxSW to tp 1; malformed meshes
    raise ValueError; 1x1 and 1x1x1 are one process without a group."""
    from vaevar_tpu_torch.parallel import mesh as tmesh

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "SLURM_NTASKS",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs 4 processes"):
        tmesh.spatial_mesh_from_arg("2x2", "cpu")
    with pytest.raises(RuntimeError, match="needs 8 processes"):
        tmesh.spatial_mesh_from_arg("2x2x2", "cpu")
    assert tmesh.parse_spatial_mesh("2x1x4") == (2, 1, 4)
    assert tmesh.parse_spatial_mesh("2x4") == (1, 2, 4)
    for bad in ("4", "2x2x2x2", "0x2", "2x0x2", "ax2", "2x"):
        with pytest.raises(ValueError, match="SHxSW"):
            tmesh.spatial_mesh_from_arg(bad, "cpu")
    one = tmesh.SpatialMesh(1, 1, 0, torch.device("cpu"))
    assert tmesh.spatial_mesh_from_arg("1x1", "cpu") == one
    assert tmesh.spatial_mesh_from_arg("1x1x1", "cpu") == one
    assert one.coords == {"tp": 0, "sh": 0, "sw": 0}
    assert tmesh.SpatialMesh(2, 2, 6, tp=2).coords == {"tp": 1, "sh": 1, "sw": 0}


# --- four ranks against one process and JAX ----------------------------------


def test_tiled_reductions_sum_to_the_unsharded(world):
    s = world["single"]
    for r, got in enumerate(world["ranks"]):
        for k in ("red_a", "red_b", "red_c", "redw_a", "redw_c", "redw_xb_low"):
            np.testing.assert_allclose(got[k], s[k], rtol=1e-5, err_msg=f"rank {r}: {k}")
        scale = np.abs(s["redw_ybar"]).mean() + s["redw_ybar"].std()
        np.testing.assert_allclose(got["redw_ybar"], s["redw_ybar"], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=f"rank {r}: ybar")


def test_obs_term_tiled_equals_replicated(world):
    """The counterpart of tests/test_sharded_da.py::
    test_obs_term_sharded_equals_replicated, with R on the whole grid."""
    for got in world["ranks"]:
        np.testing.assert_allclose(got["obs_term"], world["single"]["obs_term"], rtol=1e-5)


@pytest.mark.parametrize("name", ["full", "realwin"])
def test_copy_sum_gradient_and_jvp_equal_the_unsharded_cost(world, name):
    """J, its gradient (the copy's all-reduce) and the jvp slope (the sum's
    all-reduced tangent) of the tiled cost at a random z, on every rank."""
    s = world["single"]
    scale = np.abs(s[f"{name}_g"]).max()
    for r, got in enumerate(world["ranks"]):
        np.testing.assert_allclose(got[f"{name}_J"], s[f"{name}_J"], rtol=1e-5)
        np.testing.assert_allclose(got[f"{name}_g"], s[f"{name}_g"], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{name}_slope"], s[f"{name}_slope"], rtol=1e-5)


def _increment_rel(xa, ref, xb):
    inc, inc_ref = xa - xb, ref - xb
    return float(np.linalg.norm(inc - inc_ref) / max(np.linalg.norm(inc_ref), 1e-12))


@pytest.mark.parametrize("key", [*SOLVES, "full_jvp"])
def test_sharded_solve_matches_the_single_process_solve(world, key):
    s, got = world["single"], world["ranks"][0]
    np.testing.assert_array_equal(got[f"{key}_counts"], s[f"{key}_counts"])
    rel = _increment_rel(got[f"{key}_xa"], s[f"{key}_xa"], world["inputs"]["xb"])
    print(f"{key}: increment norm-rel against the single-process solve {rel:.3g}")
    assert rel <= 1e-3, rel
    np.testing.assert_allclose(got[f"{key}_jbjo"], s[f"{key}_jbjo"], rtol=1e-3)
    if key == "full":  # the obs fields were tiled, never replicated
        assert tuple(got["full_yo_shape"]) == (1, 69, HW[0] // MESH[0], HW[1] // MESH[1])


@pytest.mark.parametrize("key", JAX_FAST)
def test_sharded_solve_matches_jax_sharded_solve(world, key):
    rel = _increment_rel(world["ranks"][0][f"{key}_xa"], world["jax"][key],
                         world["inputs"]["xb"])
    print(f"{key}: increment norm-rel against JAX's 2x2 mesh solve {rel:.3g}")
    assert rel <= 1e-3, rel


@pytest.mark.slow
@pytest.mark.parametrize("key", [k for k in SOLVES if k not in JAX_FAST])
def test_sharded_window_solve_matches_jax_sharded_solve(world, key):
    """As above for the reduced and the real-obs window. Slow tier: JAX
    compiles each window solve for 40-50 s on the CPU (the flow rollout's
    value and gradient), which would take the file past its ~60 s budget;
    the port's side runs in the fast tier."""
    (jax_xa,) = _jax_solves(world["inputs"], *world["params"], (key,)).values()
    rel = _increment_rel(world["ranks"][0][f"{key}_xa"], jax_xa, world["inputs"]["xb"])
    print(f"{key}: increment norm-rel against JAX's 2x2 mesh solve {rel:.3g}")
    assert rel <= 1e-3, rel


def test_ranks_agree_bitwise(world):
    meta, ranks = world["meta"], world["ranks"]
    assert len({m["digest"] for m in meta}) == 1
    for k in ranks[0]:
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")


def test_mesh_layout_host_value_and_drift_check(world):
    for r, m in enumerate(world["meta"]):
        assert m["rank"] == m["again"] == r
        assert m["mesh"] == [MESH[0], MESH[1], r]
        assert m["tile_shape"] == [2, 204, HW[0] // MESH[0], HW[1] // MESH[1]]
        assert m["gathered"]
        assert "replicas drifted apart" in m["drift"]


# --- tp x sh x sw: the decoder tensor-parallel ------------------------------


def _check_tp_solve(world, run, key):
    """A tp x sh x sw run's solve `key` on rank 0 against the single
    process: equal counts, the increment within norm-rel 1e-3, Jb and Jo."""
    s, got = world["single"], run["ranks"][0]
    np.testing.assert_array_equal(got[f"{key}_counts"], s[f"{key}_counts"])
    rel = _increment_rel(got[f"{key}_xa"], s[f"{key}_xa"], world["inputs"]["xb"])
    print(f"{key}: increment norm-rel against the single-process solve {rel:.3g}")
    assert rel <= 1e-3, rel
    np.testing.assert_allclose(got[f"{key}_jbjo"], s[f"{key}_jbjo"], rtol=1e-3)


def _check_tp_jax(world, run, key):
    rel = _increment_rel(run["ranks"][0][f"{key}_xa"], run["jax"][key], world["inputs"]["xb"])
    print(f"{key}: increment norm-rel against JAX's tp x sh x sw mesh solve {rel:.3g}")
    assert rel <= 1e-3, rel


def _check_ranks_bitwise(ranks):
    for k in ranks[0]:
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("key", [*TP_SOLVES, "full_jvp"])
def test_tp_sharded_solve_matches_the_single_process_solve(world, tp_world, key):
    _check_tp_solve(world, tp_world, key)
    if key == "full":  # the obs tiled over sw alone; the tp ranks of a tile hold it both
        assert tuple(tp_world["ranks"][0]["full_yo_shape"]) == (1, 69, HW[0], HW[1] // 2)


@pytest.mark.parametrize("key", TP_SOLVES)
def test_tp_sharded_solve_matches_jax_tp_sharded_solve(world, tp_world, key):
    _check_tp_jax(world, tp_world, key)


def test_tp_ranks_agree_bitwise(tp_world):
    _check_ranks_bitwise(tp_world["ranks"])


@pytest.mark.slow
def test_2x2x2_solve_matches_single_process_and_jax(world):
    """tp 2 x sh 2 x sw 2 on 8 ranks against one process and JAX's 2x2x2
    mesh (tests/test_sharded_da.py:256-300's): slow, as JAX's own."""
    run = _tp_run(world, {"tp": 2, "sh": 2, "sw": 2})
    for key in (*TP_SOLVES, "full_jvp"):
        _check_tp_solve(world, run, key)
    for key in TP_SOLVES:
        _check_tp_jax(world, run, key)
    assert tuple(run["ranks"][0]["full_yo_shape"]) == (1, 69, HW[0] // 2, HW[1] // 2)
    _check_ranks_bitwise(run["ranks"])


if __name__ == "__main__":
    if len(sys.argv) == 3:
        _tp_worker(Path(sys.argv[1]), sys.argv[2])
    else:
        _worker(Path(sys.argv[1]))
