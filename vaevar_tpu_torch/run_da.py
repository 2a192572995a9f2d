"""Cycled vae4dvar runner on PyTorch (CLI): 3D-Var, or 4D-Var with --da_win.

    python -m vaevar_tpu_torch.run_da --da_mode vae4dvar --fast_init
    python -m vaevar_tpu_torch.run_da --da_mode vae4dvar --fast_init --da_win 6

The vae4dvar, synthetic-obs subset of run_da.py, with its flag names and
its choice of forecast model (run_da.py:308-328): with --fast_init on a grid
other than the solver grid the advance is the 0.25 deg rope model
FORECAST_025 (721x1440), else the flow model at the solver grid. With
--da_win > 1 the hourly flow model FLOW_140 also runs inside the cost.
Weights are random (--fast_init), drawn from --seed (the flow model from
--seed + 1). The run goes on the device of --device (default cuda) and fails
if that device is missing; --device cpu runs on the CPU. run_da.py's
--window_dispatch (XLA program granularity) does not apply here.

Matrix products and convolutions run in full float32 where the model asks
for float32: TF32 is switched off for both cuBLAS and cuDNN (cuDNN
convolutions default to TF32).
"""

from __future__ import annotations

import argparse
import os
import sys

_ROADMAP = {
    "mesh": "--mesh (sharded solve): ROADMAP A.13",
    "ckpt": "checkpoint loading (--vae_ckpt/--flow_ckpt/--forecast_ckpt): ROADMAP A.12",
    "data": "--data_dir (on-disk ERA5 stores): ROADMAP A.11",
    "init": "model init without --fast_init (flax initializers): ROADMAP A.12",
}


def arg_parser(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--start_time", type=str, default="2022-01-01 00:00:00")
    p.add_argument("--end_time", type=str, default="2022-01-03 00:00:00")
    p.add_argument("--coeff_dir", type=str, default="dataset/bq_info_lr/",
                   help="Q-matrix assets (new_q.npy, q<i>.npy); without them "
                        "q_type 1 uses the synthetic Q linear in lead time")
    p.add_argument("--da_mode", type=str, default="vae4dvar",
                   choices=["free_run", "interpolation", "sc4dvar", "vae4dvar"])
    p.add_argument("--da_win", type=int, default=1)
    p.add_argument("--init_lag", type=int, default=8)
    p.add_argument("--init_tp", type=int, default=0)
    p.add_argument("--Nit", type=int, default=4)
    p.add_argument("--obs_std", type=float, default=0.005)
    p.add_argument("--obs_coeff", type=float, default=1.0)
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
    p.add_argument("--q_type", type=int, default=1)
    p.add_argument("--modify_tp", type=int, default=2)
    p.add_argument("--save_interval", type=int, default=5)
    p.add_argument("--grid", type=str, default="721x1440")
    p.add_argument("--solver_grid", type=str, default="128x256")
    p.add_argument("--work_dir", type=str, default="da_cycle_results")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 compute (default on; --no-bf16 for f32)")
    p.add_argument("--fast_init", action="store_true",
                   help="random N(0, 0.02^2) weights from --seed, in seconds")
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
    for flag in ("--mesh", "--vae_ckpt", "--flow_ckpt", "--forecast_ckpt", "--data_dir"):
        p.add_argument(flag, type=str, default=None, help="not ported yet (ROADMAP)")
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


def _check_supported(args):
    if args.da_mode != "vae4dvar":
        raise NotImplementedError(
            f"--da_mode {args.da_mode}: only vae4dvar is ported "
            "(sc4dvar: ROADMAP A.10; free_run/interpolation: ROADMAP A.11)")
    if args.obs_type.startswith(("real", "prepbufr")):
        raise NotImplementedError(f"--obs_type {args.obs_type}: ROADMAP A.11")
    if args.mesh:
        raise NotImplementedError(_ROADMAP["mesh"])
    if args.vae_ckpt or args.flow_ckpt or args.forecast_ckpt:
        raise NotImplementedError(_ROADMAP["ckpt"])
    if args.data_dir:
        raise NotImplementedError(_ROADMAP["data"])
    if not args.fast_init:
        raise NotImplementedError(_ROADMAP["init"])


def main(argv=None):
    """Run the cycle; returns the CycledDA (its timings and cycle_log)."""
    args = arg_parser(argv)
    _check_supported(args)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available; pass "
            "--device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.da.cycler import CycledDA
    from vaevar_tpu_torch.da.dynamics import make_integrate
    from vaevar_tpu_torch.data.era5 import SyntheticEra5
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.utils.fast_init import fast_init

    hw = tuple(int(v) for v in args.grid.split("x"))
    shw = tuple(int(v) for v in args.solver_grid.split("x"))
    dtype = torch.bfloat16 if args.bf16 else None
    cfg = cfgs.DAConfig(
        da_mode=args.da_mode, da_win=args.da_win, nit=args.Nit,
        obs_std=args.obs_std, obs_coeff=args.obs_coeff, obs_type=args.obs_type,
        q_type=args.q_type, modify_tp=args.modify_tp, init_lag=args.init_lag,
        init_tp=args.init_tp, save_interval=args.save_interval,
        window_step_checkpoint=args.win_remat in ("both", "step"),
        lbfgs_max_evals=args.lbfgs_max_evals, lbfgs_linesearch=args.lbfgs_linesearch,
        latent_shape=(1, 8 if args.micro else 32, *shw), grid_hw=hw, solver_hw=shw,
    )
    source = SyntheticEra5(hw=hw, seed=args.seed)

    def build(model_cfg, seed):
        model = fast_init(LGUnet(model_cfg), seed=seed).to(device).eval()
        return model.requires_grad_(False)

    if args.micro:
        dec_base = cfgs.micro_vae_configs(img_size=shw)[1]
        flow_base = cfgs.micro_config(img_size=shw)
    else:
        dec_base, flow_base = fit_grid(cfgs.VAE_DECODER, shw), fit_grid(cfgs.FLOW_140, shw)
    # block remat of the decoder and the flow model when they run inside the
    # 4D-Var cost (run_da.py:284-300); 3D-Var keeps the faster backward
    block_remat = args.da_win > 1 and args.win_remat in ("both", "block")
    decoder = build(dec_base.replace(dtype=dtype, remat=block_remat), args.seed)
    flow = None
    if args.da_win > 1 or hw == shw:
        flow = build(flow_base.replace(dtype=dtype, remat=block_remat), args.seed + 1)

    if hw != shw:  # --fast_init holds (_check_supported): run_da.py:308
        if args.micro:
            fc_base = cfgs.micro_config(img_size=hw)
        elif hw == cfgs.FORECAST_025.img_size:
            fc_base = cfgs.FORECAST_025
        else:
            fc_base = fit_grid(cfgs.FLOW_140.replace(
                attn_type="rope", lg_full_attn_first=True), hw)
        forecast = build(fc_base.replace(dtype=dtype), args.seed + 2)
        forecast_integrate = make_integrate(forecast)
    else:  # advance with the flow model at the solver grid
        flow_integrate = make_integrate(flow, model_hw=shw)

        def forecast_integrate(x, steps, interpolation=True):
            return flow_integrate(x, steps, True)

    name = (f"run_stdmodify{args.modify_tp}_{args.obs_type}"
            f"_std{args.obs_std:.3f}_win{args.da_win}_Nit{args.Nit}")
    da = CycledDA(cfg, source, forecast_integrate, decoder,
                  flow=flow if args.da_win > 1 else None, coeff_dir=args.coeff_dir,
                  work_dir=os.path.join(args.work_dir, name), seed=args.seed,
                  device=str(device))
    da.run_assimilation(args.start_time, args.end_time)
    print("DA complete", flush=True)
    return da


if __name__ == "__main__":
    try:
        main()
    except NotImplementedError as e:
        print(f"not supported: {e}", file=sys.stderr)
        sys.exit(2)
