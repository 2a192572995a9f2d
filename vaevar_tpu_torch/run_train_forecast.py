"""Forecast-model training / Q-matrix / rollout-eval runner on PyTorch (CLI).

    python -m vaevar_tpu_torch.run_train_forecast --task train

The port of run_train_forecast.py with its flags and defaults: supervised
one- or two-step training with Possloss or LpLoss on synthetic ERA5 pairs,
`calculate_q` (writes `new_q.npy`, the Q-matrix asset of the DA engine, and
`q_full.npy`), and the multi-step rollout WRMSE (`eval_rollout`). The model
is FLOW_140 at --grid, or the micro config with --micro, as in the JAX CLI;
weights are random from --seed unless --model_ckpt names a port checkpoint.
States come from --data_dir (a LocalNpyStore: one (69, H, W) npy per
timestamp) or, without it, from the synthetic source of --seed. The run
goes on the device of --device (default cuda) and fails if that device is
missing; --device cpu runs on the CPU.

--mesh N trains data-parallel with DDP over N processes, one per card, as
the reference's NCCL DDP: launch with

    python -m torch.distributed.run --nproc_per_node N \
        -m vaevar_tpu_torch.run_train_forecast --mesh N ...

Each rank owns cuda:LOCAL_RANK (nccl; gloo with --device cpu) and takes
every N-th batch of the time-ordered stream (`rank_strided`), so
--batch_size is the per-rank batch and the global batch is N times it. Rank
0 alone writes the log file, the scalars, the checkpoints and params_latest.
--mesh N in a run not launched as N processes raises.

--mesh DPxSHxSW also partitions the grid over (lat, lon), DP x SH x SW
processes in JAX's row-major (dp, sh, sw) order (docs/SPATIAL_TRAINING.md):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m vaevar_tpu_torch.run_train_forecast --mesh 1x1x2 ...

Every rank of a dp index reads the same frames (the batches are strided
over the dp index, so --batch_size is the per-dp-rank batch) and keeps its
(lat, lon) tile; the model runs partitioned (LGUnet.partition: halo
exchanges for the shifted windows, window-aligned tiles where an even tile
would cut a window, the full-grid LG stage whole on every rank), each
rank's loss is its share of the global one, the gradients are summed over
the world before AdamW, and the step is the global step. DPx1x1 is --mesh
DP. A grid the mesh does not tile evenly, a level with fewer window rows or
columns than ranks along an axis, or a patch kernel over its stride on a
split axis (FORECAST_025's lat kernel 3 at SH > 1) raises ValueError; a
world other than DP x SH x SW raises. The calculate_q and eval_rollout
tasks run unpartitioned, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from datetime import datetime, timedelta


def arg_parser(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", type=str, default="train",
                   choices=["train", "calculate_q", "eval_rollout"])
    p.add_argument("--start_time", type=str, default="2022-01-01 00:00:00")
    p.add_argument("--end_time", type=str, default="2022-02-01 00:00:00")
    p.add_argument("--data_dir", type=str, default=None,
                   help="LocalNpyStore root; synthetic source if omitted")
    p.add_argument("--grid", type=str, default="128x256")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=200,
                   help="train steps per epoch / q samples / rollout length")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--val_start", type=str, default=None,
                   help="held-out validation range start; default: last "
                   "20%% of [start_time, end_time)")
    p.add_argument("--val_end", type=str, default=None)
    p.add_argument("--no_resume", action="store_true",
                   help="ignore an existing checkpoint_latest in --out_dir")
    p.add_argument("--mesh", type=str, default=None,
                   help="'N': data-parallel over N processes launched by torch.distributed.run; "
                   "'DPxSHxSW': DP x SH x SW processes, each with its (lat, lon) tile")
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--loss_type", type=str, default="Possloss",
                   choices=["Possloss", "LpLoss"])
    p.add_argument("--two_step", action="store_true")
    p.add_argument("--model_ckpt", type=str, default=None,
                   help="a port params checkpoint (the params_latest a train run writes)")
    p.add_argument("--micro", action="store_true", help="micro model config (smoke runs)")
    p.add_argument("--out_dir", type=str, default="output/forecast")
    p.add_argument("--q_lead_hours", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 compute (default on; --no-bf16 for f32)")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                   help="checkpoint each block's activations (default on; "
                   "--no-remat trades memory for speed)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default cuda; cpu for CPU runs)")
    return p.parse_args(argv)


def _time(s: str) -> datetime:
    return datetime.fromisoformat(s)


def rank_strided(it, rank: int, world: int):
    """Each process takes a disjoint stride of the time-ordered batch
    stream (DistributedSampler analogue for the sequential forecast
    loader): its local batch becomes that rank's dp slice of the global
    batch, so a multi-process run sees world_size x the data. The ragged
    tail (fewer than world_size batches) is dropped on EVERY rank: unequal
    step counts would hang the collective (the JAX CLI's rank_strided,
    run_train_forecast.py:205-234)."""
    if world == 1:
        yield from it
        return
    group = []
    for b in it:
        group.append(b)
        if len(group) == world:
            yield group[rank]
            group = []


def main(argv=None):
    """Run the task; returns (trainable, per-step losses) for `train`."""
    args = arg_parser(argv)
    import numpy as np
    import torch

    from vaevar_tpu_torch.parallel import mesh as pmesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    mesh = None
    if args.mesh:
        pmesh.init_distributed(device=args.device)
        mesh = pmesh.mesh_from_arg(args.mesh, args.device)
        device = mesh.device
    rank, world = pmesh.process_index(), pmesh.process_count()
    # the batches' stride: this rank's dp index among the dp ranks (every
    # spatial rank of a dp index reads the same frames and keeps its tile)
    dp_rank, dp_world = ((mesh.coords["dp"], mesh.dp) if isinstance(mesh, pmesh.TrainMesh)
                         else (rank, world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vaevar_tpu_torch import channels
    from vaevar_tpu_torch import config as cfgs
    from vaevar_tpu_torch.data.era5 import LocalNpyStore, SyntheticEra5
    from vaevar_tpu_torch.data.prefetch import prefetched
    from vaevar_tpu_torch.models.init import without_default_init
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.train import checkpoint as ckpt
    from vaevar_tpu_torch.train import forecast_trainer as ft
    from vaevar_tpu_torch.utils import metrics as M
    from vaevar_tpu_torch.utils.fast_init import fast_init
    from vaevar_tpu_torch.utils.logger import get_logger
    from vaevar_tpu_torch.utils.meters import ScalarWriter

    hw = tuple(int(v) for v in args.grid.split("x"))
    logger = get_logger("train_forecast", args.out_dir, rank=rank)
    if mesh is not None:
        dims = (f"dp {mesh.dp} x sh {mesh.sh} x sw {mesh.sw}" if isinstance(mesh, pmesh.TrainMesh)
                else f"dp {mesh.dp}")
        logger.info(f"mesh: {dims}, rank {rank} on {device}"
                    + (f" ({torch.distributed.get_backend()})" if mesh.distributed else ""))
    source = (LocalNpyStore(args.data_dir, hw) if args.data_dir
              else SyntheticEra5(hw=hw, seed=args.seed))
    mean = channels.MEAN.reshape(-1, 1, 1)
    std = channels.STD.reshape(-1, 1, 1)

    def norm_state(ts):
        return ((source.get_state(ts) - mean) / std).astype(np.float32)

    def pair_iter(batch, lead_hours, n_targets=1, t0=None, t1=None):
        """Yields normalized (inp, [tar1, ...]) batches of consecutive
        lead-time frames (basemodel's one/two-step supervision,
        model/model.py:212-260)."""
        t = t0 or _time(args.start_time)
        end = t1 or _time(args.end_time)
        lead = timedelta(hours=lead_hours)
        while True:
            inps, tars = [], [[] for _ in range(n_targets)]
            for _ in range(batch):
                if t + n_targets * lead > end:
                    return
                inps.append(norm_state(t))
                for s in range(n_targets):
                    tars[s].append(norm_state(t + (s + 1) * lead))
                t += timedelta(hours=6)
            yield np.stack(inps), [np.stack(ts) for ts in tars]

    base = cfgs.micro_config(img_size=hw) if args.micro else cfgs.FLOW_140.replace(
        img_size=hw, remat=args.remat)
    with without_default_init():  # a checkpoint or --fast_init fills every parameter
        model = LGUnet(base.replace(dtype=torch.bfloat16 if args.bf16 else None))
    if args.model_ckpt:
        model.load_state_dict(ckpt.restore(args.model_ckpt))
    else:
        fast_init(model, seed=args.seed)
    model.to(device)

    if args.task == "calculate_q":
        pairs = ((inp, tars[0]) for inp, tars in pair_iter(args.batch_size, args.q_lead_hours))
        q_phys = ft.calculate_q(model, pairs) * std ** 2  # physical-units variance
        path = os.path.join(args.out_dir, "new_q.npy")
        if rank == 0:
            os.makedirs(args.out_dir, exist_ok=True)
            # (T-1, 69) per-lead channel means, the load_q_matrix q_type=1 format
            np.save(path, q_phys.mean(axis=(1, 2))[None])
            np.save(os.path.join(args.out_dir, "q_full.npy"), q_phys)
        logger.info(f"Q-matrix saved to {path}; channel-mean q[z500]="
                    f"{float(q_phys.mean(axis=(1, 2))[11]):.4g}")
        return None

    if args.task == "eval_rollout":
        t = _time(args.start_time)
        preds = ft.multi_step_predict(model, norm_state(t)[None], args.steps)
        std_t = torch.as_tensor(channels.STD, device=device)
        for s in range(args.steps):
            t += timedelta(hours=6)
            gt = torch.as_tensor(norm_state(t)[None], device=device)
            wrmse = M.weighted_rmse(preds[s], gt) * std_t
            logger.info(f"lead {(s + 1) * 6:4d}h: z500 {float(wrmse[11]):.4g} "
                        f"t850 {float(wrmse[66]):.4g} t2m {float(wrmse[2]):.4g}")
        return None

    # --- task == train ----------------------------------------------------
    # held-out validation range: explicit args or the last 20% of the span
    t0, t1 = _time(args.start_time), _time(args.end_time)
    if args.val_start:
        v0 = _time(args.val_start)
        v1 = _time(args.val_end) if args.val_end else t1
        train_end = min(t1, v0)
    else:
        v0, v1 = t0 + 0.8 * (t1 - t0), t1
        train_end = v0
    n_targets = 2 if args.two_step else 1

    def train_factory(epoch):
        del epoch  # time-ordered stream, sequential over the archive
        return prefetched(rank_strided(pair_iter(args.batch_size, 6, n_targets, t0, train_end),
                                       dp_rank, dp_world))

    def val_factory():
        return prefetched(rank_strided(pair_iter(args.batch_size, 6, n_targets, v0, v1),
                                       dp_rank, dp_world))

    with (ScalarWriter(args.out_dir) if rank == 0 else contextlib.nullcontext()) as writer:
        trainable, history = ft.train_forecast(
            model, train_factory, val_factory=val_factory, epochs=args.epochs,
            steps_per_epoch=args.steps, loss_type=args.loss_type, lr=args.lr,
            two_step=args.two_step, out_shape=(2 * channels.N_CHANNELS, *hw),
            ckpt_dir=args.out_dir, resume=not args.no_resume,
            recorder=M.MetricsRecorder(["MSE", "WRMSE"]), data_std=channels.STD,
            logger=logger.info, log_every=args.log_every, mesh=mesh, writer=writer)
    # bare-params alias for downstream consumers (--model_ckpt)
    ckpt.save(os.path.join(args.out_dir, "params_latest"), model.state_dict())
    logger.info(f"saved train state to {args.out_dir}/checkpoint_latest "
                f"(+best) and bare params to params_latest")
    return trainable, history


if __name__ == "__main__":
    try:
        main()
    except NotImplementedError as e:
        print(f"not supported: {e}", file=sys.stderr)
        sys.exit(2)
