"""Cycled variational DA runner on PyTorch (CLI): vae4dvar and sc4dvar in
3D-Var, or 4D-Var with --da_win, and the free_run and interpolation
baselines.

    python -m vaevar_tpu_torch.run_da --da_mode vae4dvar --fast_init
    python -m vaevar_tpu_torch.run_da --da_mode vae4dvar --fast_init --da_win 6
    python -m vaevar_tpu_torch.run_da --da_mode sc4dvar --fast_init
    python -m vaevar_tpu_torch.run_da --da_mode vae4dvar --fast_init \
        --obs_type real_simu --use_eval
    python -m vaevar_tpu_torch.run_da --da_mode vae4dvar --vae_ckpt vae.pt \
        --flow_ckpt flow.pt --forecast_ckpt forecast.pt --data_dir era5 \
        --data_layout reference
    python -m torch.distributed.run --nproc_per_node 2 \
        -m vaevar_tpu_torch.run_da --mesh 1x2 --fast_init --obs_type real_simu
    python -m torch.distributed.run --nproc_per_node 8 \
        -m vaevar_tpu_torch.run_da --mesh 2x2x2 --fast_init

run_da.py's flag names and defaults and its choice of models
(run_da.py:268-365). Observations: the synthetic families (free_XXXX,
column_random_XXXX), prepbufr* (a 69-channel mask from station reports) and
real* (station reports gridded onto 4 + 5 * --interp_dim observation
levels, QC'd with --filter_coeff; real_simu* take the augmented truth as
the obs values). The reports come from --reports_dir (one
`%Y-%m-%d_%H.json` per time) or, without it, from a synthetic network of
--n_stations stations (seed + 3, report times spread over +-3 h when
--da_win > 1); --obs_from_numpy reads pre-gridded real obs instead.
--use_eval holds out the cells of --mask_eval (or a synthetic 20 %) and
writes error_obs.npy; --forecast_eval scores --forecast_eval_steps 6 h
forecasts from each analysis (forecast_wrmse.npy); --save_field,
--save_gt and --save_obs dump fields per cycle. The work dir is
<work_dir>/<prefix>_stdmodify..._Nit<Nit>. vae4dvar solves through the VAE
decoder; sc4dvar through the control-variable transform B^1/2 (da/cvt.py)
built from the B coefficients in --coeff_dir (len_scale.npy, reg_coeff.npy, std_sur.npy, vert_eig_value.npy,
vert_eig_vec.npy; length scales times --scale_factor) or, when they are
missing, from the calibrated synthetic B with a WARNING on stderr, and
builds no decoder. Each model role reads
its checkpoint (--vae_ckpt: a full VAE or a decoder; --flow_ckpt;
--forecast_ckpt: port checkpoints, see train/checkpoint.py), or without one
takes random weights from --seed (the flow model from --seed + 1, the
forecast model from --seed + 2): with --fast_init the N(0, 0.02^2) values
run_da.py's --fast_init draws for the same seed, bit for bit
(utils/fast_init.py), else draws from the flax initializers' distributions
(models/init.py). The advance is
the 0.25 deg rope model FORECAST_025 (or its retarget to --grid) when a
forecast checkpoint is given or --fast_init runs on a grid other than the
solver grid (run_da.py:308), else the flow model at the solver grid; with
--da_win > 1 the hourly flow model FLOW_140 also runs inside the cost.
States come from --data_dir (a LocalNpyStore, or with --data_layout
reference the reference's per-variable archive) or, without it, from the
synthetic source of --seed. An empty flag value counts as absent, as
scripts/run_da.sh passes "" for unset checkpoints. With --micro the decoder
is the micro VAE preset of the checkpoint (run_train_vae --micro's six
groups, or the converters' two) and the latent has the decoder's input
channels. The run goes on the device of
--device (default cuda) and fails if that device is missing; --device cpu
runs on the CPU. The next cycle's obs are prepared on a worker thread under
the current solve, on a CUDA stream of their own; --no_prefetch runs the
serial loop (the same numbers). One flag of run_da.py is not taken:
--window_dispatch sets how many L-BFGS iterations go into one XLA program,
which an eager solve does not have.

--mesh SHxSW is the spatially partitioned solve over SH * SW processes,
one per card (torch.distributed.run's RANK, WORLD_SIZE, LOCAL_RANK; nccl,
or gloo with --device cpu): each rank owns cuda:LOCAL_RANK and holds its
tile of the full-resolution obs fields, tiled by JAX's (lat, lon) rule
(parallel/mesh.py); every rank builds the same models and runs the same
cycle, the obs terms summed over the ranks, and rank 0 writes the work
dir. --mesh TPxSHxSW puts TP tensor-parallel ranks on each tile, TP * SH *
SW processes laid out as JAX's ("tp", "sh", "sw") mesh: the decoder's and
the flow model's LG-stage blocks are split over the TP ranks of a tile
(parallel/tensor_parallel.py; a stage whose heads TP does not divide keeps
its attention whole, and the log prints the placement of each stage), a
distinct forecast model stays whole on every rank (run_da.py:330-343), and
the obs sums run over the SH x SW ranks of one tp index. The mesh must
match the launch's world size, and TP must divide the LG stages' hidden
width.

Matrix products and convolutions run in full float32 where the model asks
for float32: TF32 is switched off for both cuBLAS and cuDNN (cuDNN
convolutions default to TF32).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def arg_parser(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--start_time", type=str, default="2022-01-01 00:00:00")
    p.add_argument("--end_time", type=str, default="2022-01-03 00:00:00")
    p.add_argument("--coeff_dir", type=str, default="dataset/bq_info_lr/",
                   help="Q-matrix assets (new_q.npy, q<i>.npy; without them "
                        "q_type 1 uses the synthetic Q linear in lead time) and "
                        "sc4dvar's B coefficients (without them the calibrated "
                        "synthetic B, with a warning)")
    p.add_argument("--da_mode", type=str, default="vae4dvar",
                   choices=["free_run", "interpolation", "sc4dvar", "vae4dvar"])
    p.add_argument("--da_win", type=int, default=1)
    p.add_argument("--interp_dim", type=int, default=40,
                   help="observation levels of real obs (4 + 5 * interp_dim channels)")
    p.add_argument("--init_lag", type=int, default=8)
    p.add_argument("--init_tp", type=int, default=0)
    p.add_argument("--Nit", type=int, default=4)
    p.add_argument("--obs_std", type=float, default=0.005)
    p.add_argument("--obs_coeff", type=float, default=1.0)
    p.add_argument("--filter_coeff", type=float, default=0.1,
                   help="real-obs quality control: keep |yo - truth| < filter_coeff * sigma")
    p.add_argument("--lbfgs_max_evals", type=int, default=None,
                   help="closure-eval budget per L-BFGS segment (default: "
                        "torch's max_iter*5//4)")
    p.add_argument("--lbfgs_linesearch", type=str, default="auto",
                   choices=("auto", "zoom", "jvp-zoom"),
                   help="strong-Wolfe probes: reverse-mode (zoom) or forward-mode "
                        "after the first (jvp-zoom, same steps). auto picks "
                        "jvp-zoom when the cost runs under torch.func.jvp, else "
                        "zoom; explicit jvp-zoom fails on a cost with the flash "
                        "attention op")
    p.add_argument("--obs_type", type=str, default="column_random_0001")
    p.add_argument("--use_eval", action="store_true",
                   help="hold out obs cells and report the obs-space error (error_obs.npy)")
    p.add_argument("--mask_eval", type=str, default=None,
                   help="eval-holdout mask .npy (C_obs, H, W); synthetic 20%% holdout "
                        "if omitted")
    p.add_argument("--reports_dir", type=str, default=None,
                   help="station-report JSON dir for real* and prepbufr* obs; "
                        "synthetic station network if omitted")
    p.add_argument("--n_stations", type=int, default=2000)
    p.add_argument("--prefix", type=str, default="run")
    p.add_argument("--q_type", type=int, default=1)
    p.add_argument("--scale_factor", type=float, default=2.0,
                   help="sc4dvar B length-scale factor")
    p.add_argument("--modify_tp", type=int, default=2)
    p.add_argument("--save_interval", type=int, default=5)
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="VAE checkpoint, full or decoder-only")
    p.add_argument("--flow_ckpt", type=str, default=None)
    p.add_argument("--forecast_ckpt", type=str, default=None)
    p.add_argument("--data_dir", type=str, default=None,
                   help="on-disk state store; synthetic source if omitted")
    p.add_argument("--data_layout", type=str, default="state",
                   choices=["state", "reference"],
                   help="state: one (69,H,W) npy per timestamp; reference: "
                        "the upstream per-variable-per-level archive layout")
    p.add_argument("--grid", type=str, default="721x1440")
    p.add_argument("--solver_grid", type=str, default="128x256")
    p.add_argument("--work_dir", type=str, default="da_cycle_results")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 compute (default on; --no-bf16 for f32)")
    p.add_argument("--fast_init", action="store_true",
                   help="random N(0, 0.02^2) weights from --seed, in seconds, "
                        "for a role without a checkpoint")
    p.add_argument("--micro", action="store_true",
                   help="micro model configs (smoke runs); latent of 8 channels")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--win_remat", type=str, default="both",
                   choices=["both", "block", "step", "none"],
                   help="rematerialization inside the 4D-Var window cost: "
                        "block-level model remat and/or one checkpoint per "
                        "rollout step")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default cuda; cpu for CPU runs)")
    p.add_argument("--mesh", type=str, default=None,
                   help="'SHxSW' (e.g. 2x4): the obs fields' (lat, lon) grid "
                        "partitioned over SH*SW processes launched with "
                        "torch.distributed.run; 'TPxSHxSW' (e.g. 2x2x2) adds TP "
                        "tensor-parallel ranks per tile for the decoder's and the "
                        "flow model's LG stages")
    p.add_argument("--no_prefetch", action="store_true",
                   help="disable the obs-prefetch worker thread (serial "
                   "obs read -> solve loop, the reference's structure)")
    p.add_argument("--save_field", action="store_true",
                   help="dump xb/xa per cycle to the work dir")
    p.add_argument("--save_gt", action="store_true",
                   help="dump the truth per cycle to the work dir")
    p.add_argument("--save_obs", action="store_true",
                   help="dump the observations per cycle to the work dir")
    p.add_argument("--forecast_eval", action="store_true",
                   help="per-cycle multi-step forecast WRMSE from the analysis "
                        "(forecast_wrmse.npy)")
    p.add_argument("--forecast_eval_steps", type=int, default=20)
    p.add_argument("--obs_from_numpy", type=str, default=None,
                   help="directory of pre-gridded obs ({year}/{YYYY-MM-DDTHH}-obs.npy "
                        "and -mask.npy) used instead of station gridding for real obs")
    p.add_argument("--spans", type=str, default=None,
                   help="record the run's spans and counters (utils/trace.py) and "
                        "write them to this JSONL file at exit")
    return p.parse_args(argv)


def fit_grid(model_cfg, grid):
    """Retarget a 1.4 deg config to another grid (run_da.py:220-234)."""
    c = model_cfg.replace(img_size=grid)
    coarse = (grid[0] // c.stride[0] // 4, grid[1] // c.stride[1] // 4)
    if min(coarse) < 1 or any(g % (s * 4 * w) for g, s, w in
                              zip(grid, c.stride, c.window_size)):
        raise SystemExit(
            f"--solver_grid {grid[0]}x{grid[1]} incompatible with model stride "
            f"{c.stride} x4 downsampling and window {c.window_size}; use "
            f"multiples of ({c.stride[0] * 4 * c.window_size[0]}, "
            f"{c.stride[1] * 4 * c.window_size[1]})")
    return c


def _load_b_assets(coeff_dir: str, scale_factor: float, device="cpu"):
    """Real B coefficients (da_4dvar.py:520-526) when present; otherwise a
    loud synthetic fallback, since a silently swapped B changes every sc4dvar
    analysis (run_da.py:137-155)."""
    from vaevar_tpu_torch.da.cvt import BMatrixAssets

    if os.path.exists(os.path.join(coeff_dir, "len_scale.npy")):
        return BMatrixAssets.load(coeff_dir, scale_factor)
    print(
        f"WARNING: B-matrix coefficient dir {coeff_dir!r} has no "
        f"len_scale.npy — falling back to CALIBRATED SYNTHETIC B "
        f"(BMatrixAssets.synthetic). Analyses will NOT match runs using "
        f"the reference's dataset/bq_info_lr coefficients; pass "
        f"--coeff_dir to use real assets.",
        file=sys.stderr, flush=True,
    )
    return BMatrixAssets.synthetic(scale_factor, device=device)


def _micro_decoder(shw, vae_ckpt):
    """--micro's decoder config: the converters' micro VAE preset (two
    groups, latent 8), or run_train_vae --micro's (six groups, latent 32)
    when --vae_ckpt holds one of those."""
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.train import checkpoint as ckpt

    dec = cfgs.micro_vae_configs(img_size=shw)[1]
    if vae_ckpt:
        sd = ckpt.vae_decoder_params(ckpt.reference_state_dict(ckpt.restore(vae_ckpt)))
        if any(k.startswith(f"enc.enc_list.{dec.n_groups}.") for k in sd):
            dec = cfgs.micro_vae_train_configs(img_size=shw)[2]
    return dec


def build_model(model_cfg, seed, device, fast=False, ckpt_path=None, vae=False):
    """The LGUnet of a model role: its checkpoint, else random weights from
    `seed` (run_da.py:268-275): JAX's --fast_init draw with `fast`
    (utils/fast_init.py), else the flax initializers' distributions. Each
    of the three writes every parameter, so the model is built without
    torch's default initialisation (models/init.py::without_default_init).
    Built and filled on the CPU, then moved to `device` once; parameters
    stay f32 under --bf16."""
    import torch

    from vaevar_tpu_torch.models.init import init_like_flax, without_default_init
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train.checkpoint import load_weights
    from vaevar_tpu_torch.utils.fast_init import fast_init

    with without_default_init():
        model = LGUnet(model_cfg)
    if ckpt_path:
        load_weights(model, ckpt_path, vae=vae)
    elif fast:
        fast_init(model, seed=seed)
    else:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


def build_models(roles: dict, device, fast=False) -> dict:
    """build_model for each role of {name: (model_cfg, seed, ckpt_path,
    vae)}, the roles at once on threads (numpy's draws, the copies and
    torch's loads release the GIL): {name: model}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(len(roles), 1)) as pool:
        futures = {name: pool.submit(build_model, cfg, seed, device, fast, ckpt, vae)
                   for name, (cfg, seed, ckpt, vae) in roles.items()}
        return {name: f.result() for name, f in futures.items()}


def main(argv=None):
    """Run the cycle; returns the CycledDA (its timings, with the seconds of
    the model set-up under "models_s", and its cycle_log)."""
    args = arg_parser(argv)
    from vaevar_tpu_torch.utils import trace

    with trace.exported(args.spans):
        return _run(args)


def _run(args):
    import numpy as np
    import torch

    from vaevar_tpu_torch.parallel import mesh as pmesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available; pass "
            "--device cpu to run on the CPU")
    tp = pmesh.parse_spatial_mesh(args.mesh)[0] if args.mesh else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.da.cycler import CycledDA
    from vaevar_tpu_torch.da.dynamics import make_integrate
    from vaevar_tpu_torch.data.era5 import LocalNpyStore, ReferenceLayoutStore, SyntheticEra5

    hw = tuple(int(v) for v in args.grid.split("x"))
    shw = tuple(int(v) for v in args.solver_grid.split("x"))
    dtype = torch.bfloat16 if args.bf16 else None
    for flag in ("vae_ckpt", "flow_ckpt", "forecast_ckpt", "data_dir", "reports_dir",
                 "obs_from_numpy", "mask_eval"):
        if getattr(args, flag) and not os.path.exists(getattr(args, flag)):
            raise SystemExit(f"--{flag} {getattr(args, flag)}: no such file or directory")
    flow_base = cfgs.micro_config(img_size=shw) if args.micro else fit_grid(cfgs.FLOW_140, shw)
    latent = {}
    if args.da_mode == "vae4dvar":  # sc4dvar's control is (69, *shw) and needs no decoder
        dec_base = (_micro_decoder(shw, args.vae_ckpt) if args.micro
                    else fit_grid(cfgs.VAE_DECODER, shw))
        latent = {"latent_shape": (1, sum(dec_base.inchans_list), *shw)}
    forecast_branch = bool(args.forecast_ckpt or (args.fast_init and hw != shw))
    # the flow model runs inside a window's cost or as the advance; else a
    # --flow_ckpt goes unread, as run_da.py restores it and never applies it
    in_cost = args.da_win > 1 and args.da_mode in ("vae4dvar", "sc4dvar")
    builds_flow = in_cost or not forecast_branch
    if tp > 1:  # the models the mesh splits (run_da.py:330-343)
        for base in ([dec_base] if latent else []) + ([flow_base] if builds_flow else []):
            pmesh.check_tensor_parallel(base, tp)
    mesh = None
    if args.mesh:  # checked against the launch before any model is built
        pmesh.init_distributed(device=args.device)
        mesh = pmesh.spatial_mesh_from_arg(args.mesh, args.device)
        device = mesh.device
        backend = (torch.distributed.get_backend() if torch.distributed.is_initialized()
                   else "one process")
        axes = (f"tp {mesh.tp} x " if args.mesh.count("x") == 2 else "") + \
            f"sh {mesh.sh} x sw {mesh.sw}"
        print(f"mesh: {axes}, rank {mesh.rank} on {device} ({backend})", flush=True)
    cfg = cfgs.DAConfig(
        da_mode=args.da_mode, da_win=args.da_win, nit=args.Nit,
        obs_std=args.obs_std, obs_coeff=args.obs_coeff, filter_coeff=args.filter_coeff,
        obs_type=args.obs_type, use_eval=args.use_eval, q_type=args.q_type,
        scale_factor=args.scale_factor, modify_tp=args.modify_tp,
        interp_dim=args.interp_dim, init_lag=args.init_lag,
        init_tp=args.init_tp, save_interval=args.save_interval,
        window_step_checkpoint=args.win_remat in ("both", "step"),
        lbfgs_max_evals=args.lbfgs_max_evals, lbfgs_linesearch=args.lbfgs_linesearch,
        grid_hw=hw, solver_hw=shw, **latent,
    )
    if args.data_dir and args.data_layout == "reference":
        source = ReferenceLayoutStore(args.data_dir, hw)
    elif args.data_dir:
        source = LocalNpyStore(args.data_dir, hw)
    else:
        source = SyntheticEra5(hw=hw, seed=args.seed)

    t_models = time.perf_counter()
    # block remat of the decoder and the flow model when they run inside the
    # 4D-Var cost (run_da.py:284-300); 3D-Var keeps the faster backward
    block_remat = args.da_win > 1 and args.win_remat in ("both", "block")
    roles = {}  # {role: (config, seed, checkpoint, vae)}, built together below
    cvt = None
    if args.da_mode == "vae4dvar":
        roles["decoder"] = (dec_base.replace(dtype=dtype, remat=block_remat), args.seed,
                            args.vae_ckpt, True)
    elif args.da_mode == "sc4dvar":  # run_da.py builds a decoder it never applies
        from vaevar_tpu_torch.da.cvt import CVTransform

        cvt = CVTransform(_load_b_assets(args.coeff_dir, args.scale_factor, device),
                          solver_hw=shw, out_hw=hw, device=device)
    if builds_flow:
        roles["flow"] = (flow_base.replace(dtype=dtype, remat=block_remat), args.seed + 1,
                         args.flow_ckpt, False)
    if forecast_branch:  # run_da.py:308
        if args.micro:
            fc_base = cfgs.micro_config(img_size=hw)
        elif hw == cfgs.FORECAST_025.img_size:
            fc_base = cfgs.FORECAST_025
        else:
            fc_base = fit_grid(cfgs.FLOW_140.replace(
                attn_type="rope", lg_full_attn_first=True), hw)
        roles["forecast"] = (fc_base.replace(dtype=dtype), args.seed + 2, args.forecast_ckpt,
                             False)
    models = build_models(roles, device, args.fast_init)
    if mesh is not None:  # every rank holds the same weights, bit for bit, before placement
        pmesh.check_replicas(pmesh.digest(*(t for name in sorted(models)
                                            for t in models[name].state_dict().values())))
    if tp > 1:  # a distinct forecast model stays whole (run_da.py:340-342)
        for role in ("decoder", "flow"):
            if role in models:
                pmesh.shard_tensor_parallel(models[role], mesh)
                for line in pmesh.tensor_parallel_report(models[role]):
                    print(f"tensor parallel {role} {line}", flush=True)
    decoder, flow = models.get("decoder"), models.get("flow")
    if forecast_branch:
        forecast_integrate = make_integrate(models["forecast"])
    else:  # advance with the flow model at the solver grid (run_da.py:323-328)
        flow_integrate = make_integrate(flow, model_hw=shw)

        def forecast_integrate(x, steps, interpolation=True):
            return flow_integrate(x, steps, True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    models_s = time.perf_counter() - t_models
    print(f"models ready in {models_s:.2f}s", flush=True)

    reports_source = None
    if args.obs_type.startswith(("real", "prepbufr")):
        # both station families read prepbufr-style JSON reports: real*
        # grids values onto the augmented obs-level space, prepbufr* only
        # the 69-channel mask (da_4dvar.py:190-274 vs :301-440)
        from vaevar_tpu_torch.data.reports import LocalReportsStore, SyntheticReports

        reports_source = (
            LocalReportsStore(args.reports_dir) if args.reports_dir
            else SyntheticReports(
                source, n_stations=args.n_stations, seed=args.seed + 3,
                # report times spread across the window, so that the slots
                # after the first see obs (run_da.py:354-358)
                dt_range=(-3.0, 3.0) if args.da_win > 1 else (0.0, 0.0)))

    name = (f"{args.prefix}_stdmodify{args.modify_tp}_{args.obs_type}"
            f"_std{args.obs_std:.3f}_win{args.da_win}_Nit{args.Nit}")
    da = CycledDA(cfg, source, forecast_integrate, decoder,
                  flow=flow if in_cost else None, cvt=cvt, coeff_dir=args.coeff_dir,
                  work_dir=os.path.join(args.work_dir, name), seed=args.seed,
                  device=str(device), reports_source=reports_source,
                  mask_eval=(np.load(args.mask_eval).astype(np.float32)
                             if args.mask_eval else None),
                  save_field=args.save_field, save_gt=args.save_gt, save_obs=args.save_obs,
                  forecast_eval=args.forecast_eval,
                  forecast_eval_steps=args.forecast_eval_steps,
                  obs_from_numpy=args.obs_from_numpy, prefetch_obs=not args.no_prefetch,
                  mesh=mesh)
    da.timings["models_s"] = models_s
    da.run_assimilation(args.start_time, args.end_time)
    print("DA complete", flush=True)
    return da


if __name__ == "__main__":
    try:
        main()
    except NotImplementedError as e:
        print(f"not supported: {e}", file=sys.stderr)
        sys.exit(2)
