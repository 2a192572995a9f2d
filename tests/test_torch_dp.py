"""Data-parallel training of the port (DDP over torch.distributed) against
the JAX package's global-batch step.

Two OS processes over gloo on the CPU, one torch thread each, like
tests/test_multiprocess.py: this file is also the worker
(`python tests/test_torch_dp.py <dir>` with torchrun's environment), and one
launch runs every distributed job of the tests below, writing each rank's
results to <dir>. The JAX side is a single process on the global batch (the
ranks' local batches in rank order), which tests/test_multiprocess.py holds
equal to JAX's own multi-process run.

- The forecast trainer: the micro FORECAST_025-shaped rope LGUnet (flash
  stage, remat) with Possloss at b1 per rank, 2 AdamW steps. The
  all-reduced gradient before step 1 against jax.grad of the global batch
  of 2: rtol 1e-3 with atol 1e-4 x the largest |gradient|; per-step losses
  rtol 1e-5; the trainable after each step atol 2.5 x lr
  (tests/test_torch_train.py's tolerances and reasons: f32 round-off through
  ~30 layers, Adam turning a round-off gradient into a +-lr step). The two
  ranks' checksums, model and logvar bounds, bitwise equal.
- The VAE trainer at b1 per rank with JAX's noise for the global batch: the
  global loss, rec and kld rtol 1e-5 and the gradient as above. The ELBO is
  a sum over the batch, so a gradient left at DDP's average (1/2 of JAX's)
  fails this by 50 %. `train_vae` itself at dp=2, with its own noise (JAX's
  draw, utils/jax_random.py), against JAX's train_vae step on the global
  batch: rtol 1e-5 (the noise within 4 ulp of JAX's).
- `init_distributed` and `mesh_from_arg`: idempotence, the raise on a
  second, different world, the raises of `--mesh 3` in a world of 2 and of
  DPxSHxSW.
- Both CLIs with `--mesh 2 --device cpu` at micro size, trained and then
  resumed from checkpoint_latest: rank 1 opens no file for writing, the
  ranks' checksums are bitwise equal; `rank_strided` yields JAX's batches.
"""

from __future__ import annotations

import ast
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
HW = (16, 32)
NC = 17
GROUPS = dict(inchans_list=(4, 13), outchans_list=(8, 26))
LR, TOTAL = 1e-4, 4
VAE_LR, SIGMA, NMC = 1e-4, 2.0, 1
CLI_FC = ["--device", "cpu", "--mesh", "2", "--micro", "--no-bf16", "--grid", "32x64",
          "--batch_size", "1", "--steps", "2", "--end_time", "2022-01-03 12:00:00",
          "--log_every", "1"]
CLI_VAE = ["--device", "cpu", "--mesh", "2", "--micro", "--fast_init", "--no-bf16", "--grid",
           "32x64", "--batch_size", "1", "--end_time", "2022-01-02 12:00:00"]


def _configs(C):
    """The forecast model (rope, flash stage, remat), the NMC flow model
    (relbias) and the VAE's encoder and decoder, all micro."""
    fc = C.micro_config(img_size=HW, flash_min_seq=16, remat=True, **GROUPS)
    enc = C.micro_config(img_size=HW, attn_type="relbias", inchans_list=(4, 13),
                         outchans_list=(4, 12))
    flow = enc.replace(outchans_list=GROUPS["outchans_list"])
    return fc, flow, enc, enc.replace(inchans_list=(2, 6), outchans_list=(4, 13))


# --- the worker (one rank) ---------------------------------------------------


def _worker(d: Path):
    torch.set_num_threads(1)
    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.parallel import mesh as pmesh
    from vaevar_tpu_torch.train import forecast_trainer as ft
    from vaevar_tpu_torch.train import vae_trainer as vt

    rank = pmesh.init_distributed(backend="gloo", device="cpu")
    out = {"rank": rank, "again": pmesh.init_distributed(device="cpu")}
    os.environ["WORLD_SIZE"] = "3"
    try:
        pmesh.init_distributed(device="cpu")
    except RuntimeError as e:
        out["second_world"] = str(e)
    os.environ["WORLD_SIZE"] = "2"
    mesh = pmesh.mesh_from_arg("2", "cpu")
    out["mesh"] = [mesh.dp, mesh.rank, str(mesh.device), mesh.distributed]
    try:
        pmesh.mesh_from_arg("3", "cpu")
    except RuntimeError as e:
        out["mesh_3"] = f"{type(e).__name__}: {e}"
    m = pmesh.mesh_from_arg("2x1x1", "cpu")  # DPx1x1 is --mesh DP
    out["mesh_2x1x1"] = [type(m).__name__, m.dp, m.rank, str(m.device), m.distributed]

    inputs = np.load(d / "inputs.npz")
    fc_cfg, flow_cfg, enc_cfg, dec_cfg = _configs(tcfg)

    # the forecast trainer: 2 steps at b1 per rank
    model = LGUnet(fc_cfg)
    model.load_state_dict(torch.load(d / "fc.pt"), strict=True)
    init_fn, step = ft.make_forecast_train_step(model.train(), "Possloss", lr=LR,
                                                total_steps=TOTAL, out_shape=(2 * NC, *HW),
                                                mesh=mesh)
    trainable, opt_state = init_fn()
    res, losses = {}, []
    for k in range(2):
        inp, tar = inputs[f"fc_inp{k}"][rank:rank + 1], inputs[f"fc_tar{k}"][rank:rank + 1]
        trainable, opt_state, loss = step(trainable, opt_state, torch.from_numpy(inp),
                                          [torch.from_numpy(tar)])
        losses.append(float(loss))
        if k == 0:
            res.update({f"grad.model.{n}": p.grad.numpy() for n, p in model.named_parameters()})
            res.update({f"grad.{n}": trainable[n].grad.numpy()
                        for n in ("max_logvar", "min_logvar")})
        res.update({f"state{k}.model.{n}": v.numpy().copy()
                    for n, v in model.state_dict().items()})
        res.update({f"state{k}.{n}": trainable[n].detach().numpy().copy()
                    for n in ("max_logvar", "min_logvar")})
    out["fc_losses"] = losses
    out["fc_checksum"] = ft.trainable_checksum(trainable)

    # the VAE trainer: one step at b1 per rank with JAX's global noise, then
    # one with the step's own generator
    flow = LGUnet(flow_cfg)
    flow.load_state_dict(torch.load(d / "flow.pt"), strict=True)
    flow.requires_grad_(False).eval()
    def fresh_vae():
        vae = VAE(enc_cfg, dec_cfg)
        vae.load_state_dict(torch.load(d / "vae.pt"), strict=True)
        return vae

    frames = inputs["vae_frames"][rank:rank + 1]
    vae = fresh_vae()
    init_fn, step = vt.make_vae_train_step(vae, flow, sigma=SIGMA, lr=VAE_LR, latent_hw=HW,
                                           nmc_steps=NMC, mesh=mesh)
    m = step(init_fn(), torch.from_numpy(frames),
             torch.from_numpy(inputs["vae_eps"][rank:rank + 1]))
    res.update({f"vgrad.{n}": p.grad.numpy() for n, p in vae.named_parameters()})
    out["vae_eps"] = {k: float(v) for k, v in m.items()}
    # train_vae's own noise: JAX's draw for (seed 5, epoch 0, step 0)
    _, hist = vt.train_vae(fresh_vae(), flow, [frames], sigma=SIGMA, lr=VAE_LR, latent_hw=HW,
                           nmc_steps=NMC, seed=5, sample_at_epoch_end=False, mesh=mesh,
                           logger=lambda *_: None)
    out["vae_train"] = hist[0]
    np.savez(d / f"rank{rank}.npz", **res)

    # the CLIs, trained and then resumed, with every file opened for writing
    # under their out dirs recorded
    from vaevar_tpu_torch import run_train_forecast, run_train_vae

    written, root = set(), str(d / "cli")

    def audit(event, args):
        # files opened for writing, and the targets of the atomic renames
        # that put torch.save's files in place
        path = None
        if event == "open" and isinstance(args[1], str) and any(c in args[1] for c in "wax+"):
            path = args[0]
        elif event == "os.rename":
            path = args[1]
        if isinstance(path, str) and path.startswith(root):
            written.add(os.path.relpath(path, d))

    sys.addaudithook(audit)
    fc_out, vae_out = str(d / "cli" / "fc"), str(d / "cli" / "vae")
    tr1, h1 = run_train_forecast.main(CLI_FC + ["--out_dir", fc_out])
    tr2, h2 = run_train_forecast.main(CLI_FC + ["--out_dir", fc_out, "--epochs", "2"])
    out["cli_fc"] = [h1, h2, ft.trainable_checksum(tr2)]
    v1, vh1 = run_train_vae.main(CLI_VAE + ["--out_dir", vae_out, "--epochs", "1"])
    v2, vh2 = run_train_vae.main(CLI_VAE + ["--out_dir", vae_out, "--epochs", "2"])
    out["cli_vae"] = [[h["loss"] for h in vh1], [h["loss"] for h in vh2],
                      vt.replicated_checksum(v2)]
    out["written"] = sorted(written)
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


# --- the tests ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs and bridged weights from numpy seeds, one 2-rank launch of
    _worker, and JAX's global-batch steps on the same inputs."""
    import jax
    import jax.numpy as jnp

    from torch_port_util import model_pair, rand
    from vaevar_tpu import config as C
    from vaevar_tpu.models.vae import VAE as JaxVAE
    from vaevar_tpu.train import forecast_trainer as jft
    from vaevar_tpu.train import vae_trainer as jvt
    from vaevar_tpu.utils.fast_init import fast_init as jax_fast_init
    from vaevar_tpu_torch.utils.port_jax import vae_state_dict_from_flax

    d = tmp_path_factory.mktemp("dp")
    fc_cfg, flow_cfg, enc_cfg, dec_cfg = _configs(C)
    jm, params, tm = model_pair(fc_cfg, seed=1)
    torch.save(tm.state_dict(), d / "fc.pt")
    jflow, flow_p, tflow = model_pair(flow_cfg, seed=3)
    torch.save(tflow.state_dict(), d / "flow.pt")
    jvae = JaxVAE(enc_cfg, dec_cfg)
    vae_p = jax.tree.map(np.asarray, jax_fast_init(
        jvae, jnp.zeros((1, NC, *HW), jnp.float32), jax.random.PRNGKey(0), seed=2))
    torch.save(vae_state_dict_from_flax(vae_p, enc_cfg, dec_cfg), d / "vae.pt")
    key = jax.random.PRNGKey(21)
    inputs = {"vae_frames": rand((2, NMC + 1, NC, *HW), 30),
              "vae_eps": np.asarray(jax.random.normal(key, (2, 8, *HW), jnp.float32))}
    for k in range(2):
        inputs[f"fc_inp{k}"] = rand((2, NC, *HW), 10 + 10 * k)
        inputs[f"fc_tar{k}"] = rand((2, NC, *HW), 11 + 10 * k)
    np.savez(d / "inputs.npz", **inputs)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(d)], cwd=REPO, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    logs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}\n{e[-6000:]}"
    ranks = [json.load(open(d / f"rank{r}.json")) for r in range(2)]
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]

    # JAX: 2 AdamW steps on the global batch of 2; the gradient of step 1
    # read from optax's first moment, (1 - b1) g after one update
    init_fn, step = jft.make_forecast_train_step(jm.apply, "Possloss", lr=LR, total_steps=TOTAL,
                                                 out_shape=(2 * NC, *HW))
    trainable, opt_state = init_fn(params)
    step_j = jax.jit(step)
    fc = {"losses": [], "states": []}
    for k in range(2):
        trainable, opt_state, loss = step_j(trainable, opt_state,
                                            jnp.asarray(inputs[f"fc_inp{k}"]),
                                            [jnp.asarray(inputs[f"fc_tar{k}"])])
        fc["losses"].append(float(loss))
        fc["states"].append(jax.tree.map(np.asarray, trainable))
        if k == 0:
            fc["grads"] = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                                       opt_state[0].mu)

    # JAX's VAE step on the global batch with the same noise
    init_fn, vstep = jvt.make_vae_train_step(jvae, jflow.apply, sigma=SIGMA, lr=VAE_LR,
                                             latent_hw=HW, nmc_steps=NMC)
    vstep = jax.jit(vstep)
    frames = jnp.asarray(inputs["vae_frames"])
    vparams, vopt0 = init_fn(None, None, None, params=vae_p)
    _, vopt, vm = vstep(vparams, vopt0, flow_p, frames, key)
    # the key of train_vae's step 0 of epoch 0 at seed 5
    step0 = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 0), 0)
    _, _, vm0 = vstep(vparams, vopt0, flow_p, frames, step0)
    vae = {"metrics": {k: float(v) for k, v in vm.items()},
           "train_vae": {k: float(v) for k, v in vm0.items()},
           "grads": vae_state_dict_from_flax(
               jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), vopt[0].mu),
               enc_cfg, dec_cfg)}
    return dict(d=d, inputs=inputs, ranks=ranks, arrays=arrays, fc=fc, vae=vae,
                fc_cfg=fc_cfg, tm=tm, logs=logs)


def _port_layout(tree, cfg):
    from vaevar_tpu_torch.utils.port_jax import forecast_trainable_from_flax

    ported = forecast_trainable_from_flax(tree, cfg)
    out = {f"model.{k}": v.numpy() for k, v in ported["model"].items()}
    out.update({k: v.numpy() for k, v in ported.items() if k != "model"})
    return out


def _rank_tree(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def test_forecast_dp2_gradient_matches_jax_global_batch(world):
    want = _port_layout(world["fc"]["grads"], world["fc_cfg"])
    scale = max(np.abs(g).max() for g in want.values())
    for r in range(2):
        got = _rank_tree(world["arrays"][r], "grad.")
        assert sorted(got) == sorted(want)
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g, rtol=1e-3, atol=1e-4 * scale,
                                       err_msg=f"rank {r}: {k}")


def test_forecast_dp2_losses_and_parameters_match_jax(world):
    for r in range(2):
        np.testing.assert_allclose(world["ranks"][r]["fc_losses"], world["fc"]["losses"],
                                   rtol=1e-5)
        for k in range(2):
            got = _rank_tree(world["arrays"][r], f"state{k}.")
            for name, v in _port_layout(world["fc"]["states"][k], world["fc_cfg"]).items():
                np.testing.assert_allclose(got[name], v, rtol=0, atol=2.5 * LR,
                                           err_msg=f"rank {r} step {k}: {name}")


def test_forecast_dp2_ranks_agree_bitwise(world):
    a, b = world["arrays"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert world["ranks"][0]["fc_checksum"] == world["ranks"][1]["fc_checksum"]
    assert any(k.endswith("max_logvar") for k in a)


def test_vae_dp2_sum_loss_and_gradient_match_jax(world):
    want = world["vae"]["metrics"]
    for r in range(2):
        got = world["ranks"][r]["vae_eps"]
        for k in ("loss", "rec_sse", "kld"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), (r, k)
        grads = _rank_tree(world["arrays"][r], "vgrad.")
        scale = max(np.abs(g.numpy()).max() for g in world["vae"]["grads"].values())
        assert sorted(grads) == sorted(world["vae"]["grads"])
        for k, g in world["vae"]["grads"].items():
            np.testing.assert_allclose(grads[k], g.numpy(), rtol=1e-3, atol=1e-4 * scale,
                                       err_msg=f"rank {r}: {k}")


def test_vae_dp2_train_vae_replays_jax_noise(world):
    """train_vae draws JAX's noise for the global batch (utils/jax_random.py,
    within 4 ulp of jax.random.normal), and each rank takes its rows: its
    first step at dp=2 equals JAX's train_vae step on the global batch."""
    want = world["vae"]["train_vae"]
    for r in range(2):
        got = world["ranks"][r]["vae_train"]
        for k in ("loss", "rec_sse", "kld"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), (r, k)


def test_init_distributed_and_mesh_from_arg(world):
    for r, out in enumerate(world["ranks"]):
        assert out["rank"] == out["again"] == r
        assert "different worlds" in out["second_world"]
        assert out["mesh"] == [2, r, "cpu", True]
        assert out["mesh_3"].startswith("RuntimeError: --mesh 3 needs 3 processes")
        assert out["mesh_2x1x1"] == ["DPMesh", 2, r, "cpu", True]


def test_mesh_without_a_launch_raises(monkeypatch):
    """Outside a launch `--mesh 2` raises (it never trains dp=1), `--mesh 1`
    is one process without a group, and WORLD_SIZE without a rendezvous
    address is refused."""
    from vaevar_tpu_torch.parallel import mesh as pmesh

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "SLURM_NTASKS",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed(device="cpu") == 0
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        pmesh.mesh_from_arg("2", "cpu")
    assert pmesh.mesh_from_arg("1", "cpu") == pmesh.DPMesh(1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="DPxSHxSW"):
        pmesh.mesh_from_arg("2x2", "cpu")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pmesh.init_distributed(device="cpu")


def test_cli_mesh2_trains_resumes_and_only_rank0_writes(world):
    r0, r1 = world["ranks"]
    h1, h2, _ = r0["cli_fc"]
    assert len(h1) == 2 and len(h2) == 2 and np.isfinite(h1 + h2).all()
    assert r1["cli_fc"][:2] == r0["cli_fc"][:2]
    assert r0["cli_fc"][2] == r1["cli_fc"][2]  # checksums, bitwise
    assert r0["cli_vae"] == r1["cli_vae"] and len(r0["cli_vae"][1]) > 0
    assert r1["written"] == []
    want = {os.path.join("cli", "fc", f) for f in (
        "run.log", "scalars.jsonl", "checkpoint_latest", "checkpoint_latest.meta.json",
        "checkpoint_best", "checkpoint_best.meta.json", "params_latest")}
    want |= {os.path.join("cli", "vae", f) for f in ("run.log", "checkpoint_latest",
                                                     "vae_latest")}
    assert want <= set(r0["written"]), sorted(want - set(r0["written"]))
    log = (world["d"] / "cli" / "fc" / "run.log").read_text()
    assert "resumed at epoch 1 step 2" in log and "mesh: dp 2, rank 0 on cpu (gloo)" in log
    with open(world["d"] / "cli" / "fc" / "checkpoint_latest.meta.json") as f:
        assert json.load(f)["step"] == 4
    assert "resumed from" in (world["d"] / "cli" / "vae" / "run.log").read_text()


def _jax_rank_strided(rank, world):
    """The JAX CLI's rank_strided (a closure in run_train_forecast.py's
    main), compiled from its source with jax's process index and count."""
    tree = ast.parse((REPO / "run_train_forecast.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "rank_strided")
    jax = types.SimpleNamespace(process_index=lambda: rank, process_count=lambda: world)
    ns = {"jax": jax}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "run_train_forecast.py", "exec"), ns)
    return ns["rank_strided"]


@pytest.mark.parametrize("n,world_size", [(7, 1), (7, 2), (8, 2), (10, 3), (2, 4)])
def test_rank_strided_equals_jax(n, world_size):
    from vaevar_tpu_torch.run_train_forecast import rank_strided

    for rank in range(world_size):
        want = list(_jax_rank_strided(rank, world_size)(iter(range(n))))
        assert list(rank_strided(iter(range(n)), rank, world_size)) == want


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
