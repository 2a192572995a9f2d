"""Data-parallel process groups: the port of vaevar_tpu/parallel/mesh.py's dp
surface, on torch.distributed.

The reference's only parallel strategy is DDP over NCCL, one process per GPU
(utils/misc.py:296-369); the JAX package rebuilt it as a "dp" mesh axis. Here
it is torch's own: `init_distributed` joins the process group of a launch
(torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or
the reference's SLURM_NTASKS / SLURM_PROCID), `mesh_from_arg` turns the CLI's
`--mesh DP` into a `DPMesh` whose rank owns `cuda:LOCAL_RANK` (or the CPU),
and the trainers wrap their models in DistributedDataParallel on it. A dp=N
run computes what a dp=1 run computes on the global batch, the ranks' local
batches in rank order (`global_batch`). The spatial "sh"/"sw" axes
(`--mesh DPxSHxSW`) are ROADMAP A.13b.

Nothing falls back: `--mesh N` in a run that was not launched as N processes
raises, and a failed NCCL init is an error, never a gloo one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# None = never initialized; else the (world_size, rank, backend) of the first
# successful init.
_distributed_initialized: list = [None]


def _launch_env():
    """(world_size, rank, local_rank, launched) from torchrun's or SLURM's
    environment; launched is whether a launcher set up a rendezvous."""
    env = os.environ
    world = env.get("WORLD_SIZE", env.get("SLURM_NTASKS"))
    rank = env.get("RANK", env.get("SLURM_PROCID"))
    local = env.get("LOCAL_RANK", env.get("SLURM_LOCALID"))
    launched = world is not None and "MASTER_ADDR" in env
    world = int(world) if world is not None else 1
    rank = int(rank) if rank is not None else 0
    local = int(local) if local is not None else rank
    return world, rank, local, launched


def init_distributed(backend: str | None = None, device: str = "cuda") -> int:
    """Join the launch's process group (the reference's SLURM-env
    `init_distributed_mode`, utils/misc.py:296-323) and return this
    process's rank.

    The world comes from torchrun's RANK / WORLD_SIZE (or SLURM_NTASKS /
    SLURM_PROCID) with MASTER_ADDR / MASTER_PORT as the rendezvous. A
    process without them is a single-process run, and this is a no-op. The
    backend is nccl for `device` cuda and gloo for cpu unless `backend`
    says otherwise. Idempotent: a second call with the same world returns
    the rank; one with a different world raises."""
    world_size, rank, local_rank, launched = _launch_env()
    if not launched and world_size == 1:
        return process_index()
    if not launched:
        raise RuntimeError(
            f"WORLD_SIZE/SLURM_NTASKS says {world_size} processes but MASTER_ADDR and "
            "MASTER_PORT are not set: launch with torch.distributed.run (torchrun)")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    world = (world_size, rank, backend)
    first = _distributed_initialized[0]
    if first is None:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method="env://", world_size=world_size,
                                rank=rank)
        _distributed_initialized[0] = world
    elif first != world:
        # a second init with a DIFFERENT world must not silently proceed
        # with the previously initialized one
        raise RuntimeError("init_distributed called twice with different worlds: "
                           f"first {first}, now {world}")
    return rank


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True)
class DPMesh:
    """The data-parallel layout of a run: `dp` processes, this one `rank`,
    its tensors on `device`."""

    dp: int
    rank: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        """Whether a process group spans the mesh (DDP wraps the model)."""
        return dist.is_initialized()


def mesh_from_arg(arg: str, device: str = "cuda") -> DPMesh:
    """CLI `--mesh` parser shared by the training CLIs: 'DP' (e.g. '8') is
    pure data parallelism over DP processes, one per device, and must equal
    the launched world size; 'DPxSHxSW' (spatial sharding) is not ported.
    The rank's device is cuda:LOCAL_RANK for `device` cuda, else the CPU."""
    try:
        dims = [int(v) for v in arg.split("x")]
    except ValueError:
        dims = []
    if len(dims) == 3:
        raise NotImplementedError(
            f"--mesh {arg} (DPxSHxSW, spatial sharding): ROADMAP A.13b")
    if len(dims) != 1 or dims[0] < 1:
        raise ValueError(f"--mesh must be 'DP' or 'DPxSHxSW', got {arg!r}")
    world = process_count()
    if dims[0] != world:
        raise RuntimeError(
            f"--mesh {dims[0]} needs {dims[0]} processes, one per device, launched with "
            f"`python -m torch.distributed.run --nproc_per_node {dims[0]}`; this run has "
            f"{world}")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", _launch_env()[2] if dist.is_initialized() else dev.index or 0)
    return DPMesh(dp=dims[0], rank=process_index(), device=dev)


def _collective_device():
    """Where a collective's tensors must live: the current card for nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the process group, on t's device (`t` itself
    when no process group is up)."""
    if not dist.is_initialized():
        return t
    c = t.detach().to(_collective_device(), copy=True)
    dist.all_reduce(c)
    return c.to(t.device)


def global_batch(local: torch.Tensor) -> torch.Tensor:
    """The global batch of a data-parallel run: every rank's local batch
    (equal shapes) concatenated in rank order along dim 0 (the JAX
    package's `global_batch` assembles the same array). The local batch
    itself when no process group is up."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    dev = _collective_device()
    t = local.detach().to(dev).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).to(local.device)


def check_replicas(checksum: float) -> float:
    """The reference's check_ddp_consistency (utils/misc.py:408-420): every
    rank's parameter checksum must equal rank 0's bit for bit, or this
    raises; returns the checksum."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return checksum
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, float(checksum))
    if any(g != got[0] for g in got):
        raise RuntimeError(f"replicas drifted apart: parameter checksums per rank {got}")
    return checksum
