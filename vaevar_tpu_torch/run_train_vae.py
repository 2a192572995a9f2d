"""VAE training runner on PyTorch (CLI): NMC background-error samples.

    python -m vaevar_tpu_torch.run_train_vae
    python -m vaevar_tpu_torch.run_train_vae --sigma 2.0 --lr 1e-4 --epochs 5

The port of run_train_vae.py with its flags and defaults (grid 128x256,
batch 8, 4 epochs, Adam at lr 1e-4, sigma 2, nmc_steps 4, bf16 compute with
f32 parameters, block remat): the flow model FLOW_140 (or, with --micro, the
JAX CLI's micro relbias configs) rolled out nmc_steps times makes each error
sample, and the VAE (VAE_ENCODER + VAE_DECODER) trains on them. The flow
model's weights come from --fengwu_ckpt (a port checkpoint or a reference
.pth, strict), else from --seed: N(0, 0.02^2) with --fast_init, draws from
the flax initializers' distributions without it. --vae_ckpt (a vae_latest,
or a reference VAE .pth) warm-starts the whole VAE strictly. Training resumes from <out_dir>/checkpoint_latest unless
--no_resume; at the end `vae_latest` holds the VAE's bare state_dict under
the reference `enc.`/`dec.` keys, which `run_da --vae_ckpt` reads as it is.
States come from --data_dir (a LocalNpyStore) or the synthetic source of
--seed. The run goes on the device of --device (default cuda) and fails if
that device is missing; --device cpu runs on the CPU. --mesh is not ported
yet and raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def arg_parser(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--start_time", type=str, default="2022-01-01 00:00:00")
    p.add_argument("--end_time", type=str, default="2022-02-01 00:00:00")
    p.add_argument("--data_dir", type=str, default=None,
                   help="LocalNpyStore root; synthetic source if omitted")
    p.add_argument("--grid", type=str, default="128x256")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--nmc_steps", type=int, default=4)
    p.add_argument("--fengwu_ckpt", type=str, default=None)
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="warm-start the VAE from a bare state_dict checkpoint")
    p.add_argument("--no_resume", action="store_true",
                   help="ignore an existing checkpoint_latest in --out_dir")
    p.add_argument("--mesh", type=str, default=None, help="not ported yet (ROADMAP A.13)")
    p.add_argument("--out_dir", type=str, default="output/vae")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 compute (default on; --no-bf16 for f32)")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                   help="checkpoint each block's activations (default on; "
                   "--no-remat trades memory for speed)")
    p.add_argument("--micro", action="store_true",
                   help="small model configs for fast CPU smoke runs")
    p.add_argument("--fast_init", action="store_true",
                   help="random N(0, 0.02^2) flow-model weights from --seed")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default cuda; cpu for CPU runs)")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns (vae, per-step metrics of this run)."""
    args = arg_parser(argv)
    if args.mesh:
        raise NotImplementedError("--mesh (data-parallel training): ROADMAP A.13")
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.data.era5 import LocalNpyStore, SyntheticEra5
    from vaevar_tpu_torch.data.nmc import NMCSequenceDataset, batched_loader
    from vaevar_tpu_torch.data.prefetch import prefetched
    from vaevar_tpu_torch.models.init import init_like_flax
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.models.vae import VAE
    from vaevar_tpu_torch.train import checkpoint as ckpt
    from vaevar_tpu_torch.train.vae_trainer import train_vae
    from vaevar_tpu_torch.utils.fast_init import fast_init
    from vaevar_tpu_torch.utils.logger import get_logger

    hw = tuple(int(v) for v in args.grid.split("x"))
    dtype = torch.bfloat16 if args.bf16 else None
    for flag in ("fengwu_ckpt", "vae_ckpt", "data_dir"):
        if getattr(args, flag) and not os.path.exists(getattr(args, flag)):
            raise SystemExit(f"--{flag} {getattr(args, flag)}: no such file or directory")
    logger = get_logger("train_vae", args.out_dir)

    source = (LocalNpyStore(args.data_dir, hw) if args.data_dir
              else SyntheticEra5(hw=hw, seed=args.seed))
    ds = NMCSequenceDataset(source, args.start_time, args.end_time, length=5)
    logger.info(f"dataset: {len(ds)} sequences")

    if args.micro:
        flow_cfg, enc_cfg, dec_cfg = cfgs.micro_vae_train_configs(img_size=hw, dtype=dtype)
    else:
        flow_cfg, enc_cfg, dec_cfg = (
            c.replace(img_size=hw, dtype=dtype, remat=args.remat)
            for c in (cfgs.FLOW_140, cfgs.VAE_ENCODER, cfgs.VAE_DECODER))
    flow = LGUnet(flow_cfg)
    if args.fengwu_ckpt:
        ckpt.load_weights(flow, args.fengwu_ckpt)
    elif args.fast_init:
        fast_init(flow, seed=args.seed)
    else:
        init_like_flax(flow, torch.Generator().manual_seed(args.seed))
    flow = flow.to(device).eval().requires_grad_(False)
    vae = VAE(enc_cfg, dec_cfg)
    # a port vae_latest or a reference VAE .pth (its `module.` prefixes go)
    init_params = (ckpt.reference_state_dict(ckpt.restore(args.vae_ckpt)) if args.vae_ckpt
                   else None)
    if init_params is None:  # the JAX CLI's vae.init: flax's distributions
        init_like_flax(vae, torch.Generator().manual_seed(args.seed))
    vae.to(device)

    def loader_factory(epoch: int):
        # reshuffles each epoch; one process, so no sharding (ROADMAP A.13)
        return prefetched(batched_loader(ds, args.batch_size, seed=args.seed, epoch=epoch))

    vae, history = train_vae(
        vae, flow, loader_factory, epochs=args.epochs, sigma=args.sigma, lr=args.lr,
        latent_hw=hw, nmc_steps=args.nmc_steps, seed=args.seed, logger=logger.info,
        ckpt_dir=args.out_dir, resume=not args.no_resume, init_params=init_params)
    # the bare VAE state_dict too (the reference's raw VAE files)
    ckpt.save(os.path.join(args.out_dir, "vae_latest"), vae.state_dict())
    logger.info(f"saved VAE checkpoint to {args.out_dir}/vae_latest")
    return vae, history


if __name__ == "__main__":
    try:
        main()
    except NotImplementedError as e:
        print(f"not supported: {e}", file=sys.stderr)
        sys.exit(2)
