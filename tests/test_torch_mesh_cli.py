"""run_da --mesh 2x2 and --mesh 2x1x2: the port's CLI on 4 gloo processes
against its own single-process run and against JAX's run_da.py on the same
mesh.

The port's ranks are launched with `python -m torch.distributed.run
--nproc_per_node 4` on this file (the worker: it calls run_da.main with the
flags, as `-m vaevar_tpu_torch.run_da` does, and each rank writes its cycle
log and the files it opened for writing beside the work dir); the
single-process run is run_da.main here with the same flags but --mesh; JAX's `python run_da.py --mesh 2x2` runs as a
subprocess on 4 virtual CPU devices (tests/test_multiprocess.py:130-185's
counterpart). The flags: --micro --fast_init --Nit 2 --use_eval
--save_field at 32x64, one cycle after a 1-step spin-up, in f32 (--no-bf16,
as tests/test_torch_fast_init_cli.py, so that the comparison with JAX
measures round-off, not bf16's rounding of activations), on the default
column_random_0001 obs (the reduced cost: no collective inside the solve)
and on real_simu (the full-grid cost on the 204-channel tiles, QC on the
tiles; obs_std 0.05, as tests/test_torch_da_surface.py, where the micro
cost's decrease is not lost in its f32 spacing). --mesh 2x1x2 is tp 2 x sh
1 x sw 2: the decoder's and the flow model's LG stages split over the 2 tp
ranks of each lon half (their 1-head attention whole, their MLPs split),
against the single process on both configurations and against JAX's
`run_da.py --mesh 2x1x2` on the first; the tolerances are the 2x2 run's.

Tolerances:
- sharded against single-process: equal iterations and evals per segment;
  J per segment, ana_wrmse.npy and error_obs.npy rtol 1e-5 (the tiles' sums
  in another order); the analysis increment (xa - xb) and the next
  background xb.npy within norm-relative 1e-3 of the increment (JAX's
  sharded-solve bound); obs counts equal.
- only rank 0 writes into the work dir.
- sharded port against JAX's sharded run: J per segment within half a unit
  of JAX's printed 4th digit + rel 1e-5 (tests/test_torch_fast_init_cli.py);
  bg_wrmse, ana_wrmse and error_obs rtol 1e-5; the analysis increment
  within norm-relative 1e-3.
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
FLAGS = ["--micro", "--fast_init", "--grid", "32x64", "--solver_grid", "32x64", "--init_lag", "1",
         "--Nit", "2", "--use_eval", "--save_field", "--no-bf16",
         "--end_time", "2022-01-01 06:00:00"]
CONFIGS = {"column_random": [], "real_simu": ["--obs_type", "real_simu", "--obs_std", "0.05"]}
RTOL = 1e-5
STAMP = "2022-01-01_00:00:00"


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _worker(out: str, argv: list):
    """One rank: run_da.main(argv), recording the files it opens for
    writing (and the directories it makes) under the work dir; writes
    <out>.<rank>, with the cycle log."""
    torch.set_num_threads(1)
    from vaevar_tpu_torch import run_da

    root, written = argv[argv.index("--work_dir") + 1], set()

    def audit(event, args):
        path = None
        if event == "open" and isinstance(args[1], str) and any(c in args[1] for c in "wax+"):
            path = args[0]
        elif event in ("os.mkdir", "os.rename"):
            path = args[0] if event == "os.mkdir" else args[1]
        if isinstance(path, str) and path.startswith(root):
            written.add(os.path.relpath(path, root))

    sys.addaudithook(audit)
    da = run_da.main(argv)
    with open(f"{out}.{da.mesh.rank}", "w") as f:
        json.dump({"cycle_log": da.cycle_log, "work_dir": da.work_dir,
                   "written": sorted(written)}, f, default=str)


def _launch(tmp, name, extra, mesh="2x2"):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "4", "--master_addr", "localhost", "--master_port", str(_free_port()), __file__,
           str(tmp / name), *FLAGS, *extra, "--device", "cpu", "--mesh", mesh,
           "--work_dir", str(tmp / f"{name}_mesh")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=tmp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_fast_init_cli import _jax_cycles

    from vaevar_tpu_torch import run_da

    tmp = tmp_path_factory.mktemp("mesh_cli")
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = {jname: subprocess.Popen(
        [sys.executable, str(REPO / "run_da.py"), *FLAGS, "--mesh", mesh, "--work_dir",
         str(tmp / jname)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=jax_env, cwd=tmp) for jname, mesh in (("jax", "2x2"), ("jax_tp", "2x1x2"))}
    procs.update({name: _launch(tmp, name, extra) for name, extra in CONFIGS.items()})
    procs.update({f"{name}_tp": _launch(tmp, f"{name}_tp", extra, "2x1x2")
                  for name, extra in CONFIGS.items()})
    try:
        torch.set_num_threads(1)
        single = {name: run_da.main([*FLAGS, *extra, "--device", "cpu", "--work_dir",
                                     str(tmp / f"{name}_single")])
                  for name, extra in CONFIGS.items()}
        logs = {name: p.communicate(timeout=400) for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for name, p in procs.items():
        out, err = logs[name]
        assert p.returncode == 0, f"{name} failed:\n{out[-3000:]}\n{err[-6000:]}"
    runs = [*CONFIGS, *(f"{name}_tp" for name in CONFIGS)]
    sharded = {name: json.load(open(tmp / f"{name}.0")) for name in runs}
    written = {name: [json.load(open(tmp / f"{name}.{r}"))["written"] for r in range(4)]
               for name in runs}
    (jax_dir,) = (tmp / "jax").glob("run_*")
    (jax_tp_dir,) = (tmp / "jax_tp").glob("run_*")
    return dict(single=single, sharded=sharded, written=written, logs=logs, jax_dir=jax_dir,
                jax_cycles=_jax_cycles(logs["jax"][0]), jax_tp_dir=jax_tp_dir,
                jax_tp_cycles=_jax_cycles(logs["jax_tp"][0]))


def _load(work_dir, name):
    return np.load(Path(work_dir) / f"{name}.npy", allow_pickle=True)


def _increment_rel(work, ref_work):
    inc = _load(work, f"xa_{STAMP}") - _load(work, f"xb_{STAMP}")
    ref = _load(ref_work, f"xa_{STAMP}") - _load(ref_work, f"xb_{STAMP}")
    return float(np.linalg.norm(inc - ref) / np.linalg.norm(ref)), float(np.linalg.norm(ref))


def _check_against_single(da, sharded, name):
    (c0,), (c1,) = da.cycle_log, sharded["cycle_log"]
    assert c1["n_iters"] == c0["n_iters"] and c1["n_evals"] == c0["n_evals"]
    assert c1["linesearch"] == c0["linesearch"] == "jvp-zoom"
    for k in ("n_gridded", "n_kept"):
        assert c1.get(k) == c0.get(k), k
    j0 = np.add(c0["jb"], c0["jo"])
    np.testing.assert_allclose(np.add(c1["jb"], c1["jo"]), j0, rtol=RTOL)
    work, ref = sharded["work_dir"], da.work_dir
    assert Path(work).name == Path(ref).name
    for f in ("ana_wrmse", "error_obs"):
        np.testing.assert_allclose(_load(work, f), _load(ref, f), rtol=RTOL, err_msg=f)
    np.testing.assert_array_equal(_load(work, "bg_wrmse"), _load(ref, "bg_wrmse"))
    rel, norm = _increment_rel(work, ref)
    print(f"{name}: analysis increment norm-rel {rel:.3g} against the single-process run")
    assert rel <= 1e-3, rel
    assert np.linalg.norm(_load(work, "xb") - _load(ref, "xb")) <= 1e-3 * norm


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_cli_matches_the_single_process_cli(runs, name):
    _check_against_single(runs["single"][name], runs["sharded"][name], name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tp_cli_matches_the_single_process_cli(runs, name):
    """--mesh 2x1x2 against one process: the same checks as 2x2's, and the
    cycle log's parameter bytes under the single run's (the split MLPs)."""
    _check_against_single(runs["single"][name], runs["sharded"][f"{name}_tp"], name)
    (c0,), (c1,) = runs["single"][name].cycle_log, runs["sharded"][f"{name}_tp"]["cycle_log"]
    assert 0 < c1["param_bytes"] < c0["param_bytes"]


def _check_against_jax(sharded, jdir, cycles, mesh):
    from test_torch_fast_init_cli import _printed_close

    ((t, printed),) = cycles
    (c,) = sharded["cycle_log"]
    assert t == c["time"] == "2022-01-01 00:00:00"
    port = list(zip(c["jb"], c["jo"]))
    assert len(port) == len(printed) == 3
    for k, ((pb, po), (jb, jo)) in enumerate(zip(port, printed)):
        assert _printed_close(pb, jb) and _printed_close(po, jo), (k, pb, jb, po, jo)
    work = Path(sharded["work_dir"])
    assert jdir.name == work.name
    for f in ("bg_wrmse", "ana_wrmse", "error_obs"):
        np.testing.assert_allclose(_load(work, f), _load(jdir, f), rtol=RTOL, err_msg=f)
    rel, _ = _increment_rel(work, jdir)
    print(f"analysis increment norm-rel {rel:.3g} against JAX's --mesh {mesh} run")
    assert rel <= 1e-3, rel


def test_sharded_cli_matches_jax_sharded_cli(runs):
    _check_against_jax(runs["sharded"]["column_random"], runs["jax_dir"], runs["jax_cycles"],
                       "2x2")


def test_tp_cli_matches_jax_tp_cli(runs):
    _check_against_jax(runs["sharded"]["column_random_tp"], runs["jax_tp_dir"],
                       runs["jax_tp_cycles"], "2x1x2")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_only_rank0_writes_and_ranks_log_the_mesh(runs, name):
    out = runs["logs"][name][0]
    for r in range(4):
        assert f"mesh: sh 2 x sw 2, rank {r} on cpu (gloo)" in out
    assert out.count("DA complete") == 4
    r0, *others = runs["written"][name]
    assert others == [[], [], []]
    run = Path(runs["sharded"][name]["work_dir"]).name
    want = {os.path.join(run, f) for f in ("xb.npy", "current_time.txt", "ana_wrmse.npy",
                                           "error_obs.npy", f"xa_{STAMP}.npy")}
    assert want <= set(r0), sorted(want - set(r0))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tp_only_rank0_writes_and_ranks_log_the_mesh_and_placement(runs, name):
    out = runs["logs"][f"{name}_tp"][0]
    for r in range(4):
        assert f"mesh: tp 2 x sh 1 x sw 2, rank {r} on cpu (gloo)" in out
    for role in ("decoder", "flow"):
        assert out.count(f"tensor parallel {role} net.layers.0 (1 block): attention whole "
                         "(1 head on every rank), mlp 32 of 64 hidden units per rank") == 4
    assert out.count("DA complete") == 4
    r0, *others = runs["written"][f"{name}_tp"]
    assert others == [[], [], []]
    run = Path(runs["sharded"][f"{name}_tp"]["work_dir"]).name
    want = {os.path.join(run, f) for f in ("xb.npy", "current_time.txt", "ana_wrmse.npy",
                                           "error_obs.npy", f"xa_{STAMP}.npy")}
    assert want <= set(r0), sorted(want - set(r0))


def test_mesh_arguments_that_raise(tmp_path, monkeypatch):
    """TPxSHxSW parses, and outside a launch of TP*SH*SW processes it raises
    as SHxSW does; a malformed mesh raises, and so does a tp that does not
    divide the LG stages' hidden width (the micro models' 64), all before
    any model is built."""
    from vaevar_tpu_torch import run_da

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "SLURM_NTASKS",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    argv = [*FLAGS, "--device", "cpu", "--work_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="needs 8 processes"):
        run_da.main([*argv, "--mesh", "2x2x2"])
    with pytest.raises(RuntimeError, match="needs 4 processes"):
        run_da.main([*argv, "--mesh", "2x2"])
    for bad in ("2x2x2x2", "2x", "0x2x2"):
        with pytest.raises(ValueError, match="TPxSHxSW"):
            run_da.main([*argv, "--mesh", bad])
    with pytest.raises(ValueError, match=r"mlp: hidden width 64 does not divide by tp 3"):
        run_da.main([*argv, "--mesh", "3x1x1"])
    assert not any(tmp_path.iterdir())


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2:])
