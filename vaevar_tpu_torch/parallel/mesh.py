"""Process groups and meshes: the port of vaevar_tpu/parallel/mesh.py's dp,
spatial (sh, sw), tensor-parallel (tp) and expert-parallel (ep) surfaces, on
torch.distributed.

The reference's only parallel strategy is DDP over NCCL, one process per GPU
(utils/misc.py:296-369); the JAX package rebuilt it as a "dp" mesh axis. Here
it is torch's own: `init_distributed` joins the process group of a launch
(torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or
the reference's SLURM_NTASKS / SLURM_PROCID), `mesh_from_arg` turns the CLI's
`--mesh DP` into a `DPMesh` whose rank owns `cuda:LOCAL_RANK` (or the CPU),
and the trainers wrap their models in DistributedDataParallel on it. A dp=N
run computes what a dp=1 run computes on the global batch, the ranks' local
batches in rank order (`global_batch`).

The trainers' `--mesh DPxSHxSW` (SH * SW > 1) is a `TrainMesh`: DP x SH x SW
processes in JAX's row-major ("dp", "sh", "sw") order, each holding its dp
rows' (lat, lon) tile of the frames and of every activation of a spatially
partitioned LGUnet (`TrainMesh.tiling`, parallel/spatial.py,
docs/SPATIAL_TRAINING.md); the parameter gradients are summed over the world
(`all_sum_grads`). Both trainers take it. `DPx1x1` is `--mesh DP`.

run_da's `--mesh SHxSW` is the spatially partitioned solve
(`spatial_mesh_from_arg`, a `SpatialMesh`): SH x SW processes, one per
device, each holding its tile of the full-resolution observation fields,
tiled by the JAX package's own rule (`state_spec_for`, `tile_for`: an axis
goes only on a dim it divides, never an uneven tile). Where JAX's GSPMD
partitions every array, the port partitions only those fields: the models,
the control variable, the background, the truth and the analysis stay whole
on every rank (so the JAX package's `replicate` has no counterpart: each
rank builds the same models from the same seed and reads the same states),
and the ranks stay in lockstep because every
value the solver reads from the tiles is summed over the ranks first
(`all_sum`, `sum_over_tiles`, and the Megatron-style pair `copy_to_ranks` /
`sum_over_ranks` inside a cost). `host_value` all-gathers a tiled field.

`--mesh TPxSHxSW` adds a tensor-parallel axis in front (JAX's ("tp", "sh",
"sw") mesh, row-major): the TP ranks of one (sh, sw) tile form a tp group,
over which the models' LG-stage blocks are split Megatron-style
(parallel/tensor_parallel.py, `shard_tensor_parallel`; `shard_experts` is
the expert-parallel placement of the zoo's MoE banks); the SH x SW ranks of
one tp index form a spatial group, over which the obs sums run. Both kinds
of group are made on every rank in the same order (`new_group` is
collective over the world). A `SpatialMesh` with tp 1 makes no groups: its
sums run over the world.

Nothing falls back: `--mesh N` (or SHxSW) in a run that was not launched as
that many processes raises, and a failed NCCL init is an error, never a
gloo one. Collectives stage their tensors through the host under gloo
(`_collective_device`), which takes CPU tensors.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
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
    the rank, as does one that names no backend in a group already up (a
    caller that set up gloo on a card, then run_da's own call); one with a
    different world raises."""
    world_size, rank, local_rank, launched = _launch_env()
    if not launched and world_size == 1:
        return process_index()
    if not launched:
        raise RuntimeError(
            f"WORLD_SIZE/SLURM_NTASKS says {world_size} processes but MASTER_ADDR and "
            "MASTER_PORT are not set: launch with torch.distributed.run (torchrun)")
    first = _distributed_initialized[0]
    if backend is None and first is not None:
        backend = first[2]
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    world = (world_size, rank, backend)
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


def parse_train_mesh(arg: str) -> tuple:
    """(dp, sh, sw) of the training CLIs' `--mesh`: 'DP' (sh = sw = 1) or
    'DPxSHxSW'; raises ValueError on anything else."""
    try:
        dims = [int(v) for v in arg.split("x")]
    except ValueError:
        dims = []
    if len(dims) not in (1, 3) or min(dims) < 1:
        raise ValueError(f"--mesh must be 'DP' or 'DPxSHxSW', got {arg!r}")
    return (dims[0], 1, 1) if len(dims) == 1 else tuple(dims)


def mesh_from_arg(arg: str, device: str = "cuda"):
    """CLI `--mesh` parser shared by the training CLIs. 'DP' (e.g. '8'), or
    'DPx1x1', is pure data parallelism over DP processes, one per device: a
    DPMesh. 'DPxSHxSW' with SH * SW > 1 (e.g. '1x2x2') adds the spatial
    partition: a TrainMesh, with its groups made here on every rank. The
    mesh must be the launched world. The rank's device is cuda:LOCAL_RANK
    for `device` cuda, else the CPU."""
    dp, sh, sw = parse_train_mesh(arg)
    _check_world(arg, dp * sh * sw)
    if sh * sw == 1:
        return DPMesh(dp=dp, rank=process_index(), device=_rank_device(device))
    mesh = TrainMesh(dp, sh, sw, rank=process_index(), device=_rank_device(device))
    if dist.is_initialized():
        sizes = {"dp": dp, "sh": sh, "sw": sw}
        groups = {}
        for name, along in (("group", ("sh", "sw")), ("dp_group", ("dp",)),
                            ("lat_group", ("sh",)), ("lon_group", ("sw",))):
            n = int(np.prod([sizes[a] for a in along]))
            if 1 < n < dp * sh * sw:  # a group of the world is the world (None)
                groups[name] = _groups_along(sizes, along, mesh.rank)
        mesh = replace(mesh, **groups)
    return mesh


def _check_world(arg, n):
    world = process_count()
    if n != world:
        raise RuntimeError(
            f"--mesh {arg} needs {n} processes, one per device, launched with "
            f"`python -m torch.distributed.run --nproc_per_node {n}`; this run has {world}")


def _rank_device(device):
    """This rank's device: cuda:LOCAL_RANK for `device` cuda, else the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", _launch_env()[2] if dist.is_initialized() else dev.index or 0)
    return dev


def _collective_device():
    """Where a collective's tensors must live: the current card for nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over `group` (None: the whole process group), on t's
    device (`t` itself when no process group is up). Every rank receives
    the same bits."""
    if not dist.is_initialized():
        return t
    c = t.detach().to(_collective_device(), copy=True)
    dist.all_reduce(c, group=group)
    return c.to(t.device)


def _all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's `t` (equal shapes) of `group` (None: the world), in the
    group's rank order, on the collective device."""
    t = t.detach().to(_collective_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def global_batch(local: torch.Tensor) -> torch.Tensor:
    """The global batch of a data-parallel run: every rank's local batch
    (equal shapes) concatenated in rank order along dim 0 (the JAX
    package's `global_batch` assembles the same array). The local batch
    itself when no process group is up."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    return torch.cat(_all_gather(local)).to(local.device)


def check_replicas(checksum):
    """The reference's check_ddp_consistency (utils/misc.py:408-420): every
    rank's checksum (a number, or a digest string) must equal rank 0's bit
    for bit, or this raises; returns the checksum."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return checksum
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, checksum)
    if any(g != got[0] for g in got):
        raise RuntimeError(f"replicas drifted apart: checksums per rank {got}")
    return checksum


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes in C order: equal exactly when the
    tensors are equal bit for bit (the ranks' lockstep check)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# --- the training mesh of run_train_vae / run_train_forecast --mesh DPxSHxSW --


@dataclass(frozen=True)
class TrainMesh:
    """The trainers' `--mesh DPxSHxSW` with SH * SW > 1 (run_train_vae and
    run_train_forecast): dp x sh x sw processes laid out as JAX's
    `make_mesh({"dp", "sh", "sw"})`, row-major, so rank r sits at
    d = r // (sh sw), then (r % (sh sw)) // sw, r % sw; this one is `rank`,
    its tensors on `device`. `group` is its spatial group (the sh x sw ranks
    of its dp index: the gathers of a whole field, the LpLoss norms),
    `dp_group` its dp group (the dp ranks of its tile; None with dp 1: the
    forecast trainer's validation gathers the dp rows over it),
    `lat_group` and `lon_group` the ranks of its tile's column and row of
    tiles, over which the halos and re-tilings go; None is the whole world
    where a group would span it."""

    dp: int
    sh: int
    sw: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: object = None
    dp_group: object = None
    lat_group: object = None
    lon_group: object = None

    @property
    def distributed(self) -> bool:
        return dist.is_initialized()

    @property
    def coords(self) -> dict:
        d, r = divmod(self.rank, self.sh * self.sw)
        s, w = divmod(r, self.sw)
        return {"dp": d, "sh": s, "sw": w}

    @property
    def tiling(self):
        """This rank's tile of every (..., H, W) field: the JAX trainers'
        P(..., "sh", "sw"), with its halo and gather groups."""
        from vaevar_tpu_torch.parallel.spatial import Tiling

        c = self.coords
        return Tiling(self.sh, self.sw, c["sh"], c["sw"], self.group, self.lat_group,
                      self.lon_group)

    def batch_spec(self, b: int) -> tuple:
        """(start, stop) of this rank's rows of the global batch of dp x b
        (JAX's `batch_spec`, P("dp")): its dp index's b rows."""
        d = self.coords["dp"]
        return d * b, (d + 1) * b


_GRAD_BUCKET = 2 ** 24  # elements per all-reduce of all_sum_grads: 64 MB of f32


def all_sum_grads(params, group=None) -> None:
    """Replace each parameter's gradient by its sum over `group` (None:
    the world), in place, in all-reduces of up to _GRAD_BUCKET elements of
    the flattened gradients (a parameter without one adds zeros). Every
    rank receives the same bits."""
    if not dist.is_initialized():
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    start = 0
    while start < len(params):
        stop, n = start, 0
        while stop < len(params) and (n == 0 or n + params[stop].numel() <= _GRAD_BUCKET):
            n += params[stop].numel()
            stop += 1
        chunk = params[start:stop]
        flat = all_sum(torch.cat([p.grad.reshape(-1) for p in chunk]), group)
        for p, g in zip(chunk, flat.split([p.numel() for p in chunk])):
            p.grad.copy_(g.view_as(p.grad))
        start = stop


# --- the spatial mesh of run_da --mesh SHxSW ----------------------------------


@dataclass(frozen=True)
class SpatialMesh:
    """run_da's `--mesh SHxSW` or `TPxSHxSW`: tp x sh x sw processes laid
    out as the JAX package's `make_mesh` lays out its devices over ("tp",
    "sh", "sw"), row-major, so rank r sits at t = r // (sh sw), then
    (r % (sh sw)) // sw, r % sw; this one is `rank`, its tensors on
    `device`. `group` is the process group of its spatial group (the sh x
    sw ranks of its tp index) and `tp_group` that of its tp group (the tp
    ranks of its tile); None is the whole world (or no process group), as
    with tp 1."""

    sh: int
    sw: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    tp: int = 1
    group: object = None
    tp_group: object = None

    @property
    def axes(self) -> dict:
        """The spatial axes, which tile the fields."""
        return {"sh": self.sh, "sw": self.sw}

    @property
    def coords(self) -> dict:
        t, r = divmod(self.rank, self.sh * self.sw)
        i, j = divmod(r, self.sw)
        return {"tp": t, "sh": i, "sw": j}


@dataclass(frozen=True)
class ExpertMesh:
    """An "ep" axis of `ep` ranks (JAX's {"ep": E} mesh): this rank's index
    along it and the process group of its ranks (None: the whole world)."""

    ep: int
    index: int = 0
    group: object = None


class Tile(NamedTuple):
    """A rank's tile of a (..., H, W) field: its rows and columns, whether
    its sums count (`primary`: where the rule leaves an axis unused, the
    ranks along it hold the same tile, and only the first adds its partial
    sums), and the process group its sums run over (the mesh's spatial
    group; None: the world)."""

    rows: slice
    cols: slice
    primary: bool
    group: object = None


def state_spec_for(mesh: SpatialMesh, shape) -> tuple:
    """The JAX package's `state_spec_for` (vaevar_tpu/parallel/mesh.py:
    107-133) on a SpatialMesh, as the tuple of PartitionSpec entries: a
    mesh axis goes only on a dim it evenly divides; where lat cannot take
    sh but lon divides sh * sw (721 = 7 x 103 rows at 0.25 deg), both axes
    go on lon, and the transposed case likewise; an axis that fits nowhere
    is dropped (its ranks hold equal tiles)."""
    nsh = mesh.axes
    h, w = shape[-2], shape[-1]
    lead = [None] * (len(shape) - 2)
    sh_ok = h % nsh["sh"] == 0
    sw_ok = w % nsh["sw"] == 0
    if sh_ok and sw_ok:
        return (*lead, "sh", "sw")
    if not sh_ok and w % (nsh["sh"] * nsh["sw"]) == 0:
        return (*lead, None, ("sh", "sw"))
    if not sw_ok and h % (nsh["sh"] * nsh["sw"]) == 0:
        return (*lead, ("sh", "sw"), None)
    return (*lead, "sh" if sh_ok else None, "sw" if sw_ok else None)


def tile_for(mesh: SpatialMesh, shape) -> Tile:
    """This rank's tile of a (..., H, W) field under `state_spec_for`: what
    JAX's NamedSharding places on the rank's device (`shard_shape` and
    `devices_indices_map` semantics; a dim over ("sh", "sw") is split sh *
    sw ways, sh major)."""
    used, bounds = set(), []
    for n, entry in zip(shape[-2:], state_spec_for(mesh, shape)[-2:]):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        used.update(names)
        idx, parts = 0, 1
        for a in names:
            idx, parts = idx * mesh.axes[a] + mesh.coords[a], parts * mesh.axes[a]
        size = n // parts
        bounds.append(slice(idx * size, (idx + 1) * size))
    primary = all(mesh.coords[a] == 0 for a in ("sh", "sw") if a not in used)
    return Tile(*bounds, primary, mesh.group)


def is_full(x) -> bool:
    """Whether x is a (..., H, W) field that tiles: the JAX solver's rule
    (vaevar_tpu/da/solver.py:392-397), both of the last two dims > 1;
    broadcastables such as a per-channel R (T, C, 1, 1) are replicated."""
    return len(x.shape) >= 2 and x.shape[-1] > 1 and x.shape[-2] > 1


def shard(x, mesh: SpatialMesh | None):
    """This rank's tile of a whole field x (numpy or torch, a view); x
    itself without a mesh or when x is broadcastable."""
    if mesh is None or not is_full(x):
        return x
    t = tile_for(mesh, x.shape)
    return x[..., t.rows, t.cols]


def host_value(x, mesh: SpatialMesh | None, hw) -> np.ndarray:
    """This rank's tile x of a (..., *hw) field, all-gathered over its
    spatial group into the whole field on the host (the JAX package's
    `host_value`): a collective, so every rank calls it. x itself, read to
    the host, without a mesh or on one tile."""
    if mesh is None or mesh.sh * mesh.sw == 1:
        return x.detach().cpu().numpy()
    parts = [p.cpu().numpy() for p in _all_gather(x, mesh.group)]
    out = np.empty((*x.shape[:-2], *hw), dtype=parts[0].dtype)
    for r, part in enumerate(parts):
        t = tile_for(replace(mesh, rank=r), out.shape)
        out[..., t.rows, t.cols] = part
    return out


def sum_over_tiles(tile: Tile, *parts) -> list:
    """Each of `parts` (this rank's partial sums over its tile) summed over
    the tile's group in one all-reduce; a rank whose tile another rank holds
    too adds zeros. Every rank receives the same bits."""
    flat = torch.cat([p.reshape(-1) for p in parts]) * float(tile.primary)
    flat = all_sum(flat) if tile.group is None else all_sum(flat, tile.group)
    return [v.reshape(p.shape) for v, p in zip(flat.split([p.numel() for p in parts]), parts)]


class _CopyToRanks(torch.autograd.Function):
    """Megatron's "copy": the identity forward, the sum over the group's
    ranks of the branch's gradients backward; the tangent passes through."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return t.clone()


class _SumOverRanks(torch.autograd.Function):
    """Megatron's "reduce": the sum over the group's ranks forward, the
    identity backward; the tangent is summed too, so a jvp reads every
    rank's slope."""

    @staticmethod
    def forward(x, group):
        return all_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return all_sum(t, ctx.group)


def copy_to_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """x where a rank-local branch starts (the obs term on the tiles, from
    the low-res increment; a tensor-parallel layer's slice): its gradient
    there is the sum of every rank's of `group` (None: the world)."""
    return _CopyToRanks.apply(x, group)


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks of `group` (None: the world), differentiably
    in both modes: the rank-local partials of a branch that began at
    `copy_to_ranks`."""
    return _SumOverRanks.apply(x, group)


def sum_over_tile_ranks(x: torch.Tensor, tile: Tile) -> torch.Tensor:
    """A rank-local scalar of the tiles (the obs term) summed over the
    tile's group by `sum_over_ranks`; a rank with a duplicate tile adds
    zero."""
    return sum_over_ranks(x * float(tile.primary), tile.group)


def _groups_along(sizes: dict, along: tuple, rank: int):
    """The process group of this `rank`'s ranks along the axes `along` of a
    row-major mesh of `sizes` ({axis: size}): every group of the mesh is
    made, on every rank in the same order (`new_group` is collective over
    the world, and ranks that made them in other orders could hang)."""
    names = list(sizes)
    ranks = np.arange(int(np.prod(list(sizes.values())))).reshape(list(sizes.values()))
    rest = [names.index(a) for a in names if a not in along]
    rows = ranks.transpose(rest + [names.index(a) for a in along]).reshape(
        -1, int(np.prod([sizes[a] for a in along])))
    mine = None
    for members in rows.tolist():
        g = dist.new_group(members)
        if rank in members:
            mine = g
    return mine


def parse_spatial_mesh(arg: str) -> tuple:
    """(tp, sh, sw) of run_da's `--mesh` 'SHxSW' (tp 1) or 'TPxSHxSW';
    raises ValueError on anything else."""
    try:
        dims = [int(v) for v in arg.split("x")]
    except ValueError:
        dims = []
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh must be 'SHxSW' (e.g. 2x4) or 'TPxSHxSW' (e.g. 2x2x2), "
                         f"got {arg!r}")
    return tuple(dims) if len(dims) == 3 else (1, *dims)


def spatial_mesh_from_arg(arg: str, device: str = "cuda") -> SpatialMesh:
    """run_da's `--mesh`: 'SHxSW' (e.g. 2x4) partitions the observation
    fields' (lat, lon) grid over SH * SW processes, one per device;
    'TPxSHxSW' (e.g. 2x2x2) adds TP tensor-parallel ranks per tile, TP * SH
    * SW processes, with the tp and spatial groups of a tp > 1 made here on
    every rank. The mesh must be the launched world. The rank's device is
    cuda:LOCAL_RANK for `device` cuda, else the CPU."""
    tp, sh, sw = parse_spatial_mesh(arg)
    _check_world(arg, tp * sh * sw)
    mesh = SpatialMesh(sh=sh, sw=sw, rank=process_index(), device=_rank_device(device), tp=tp)
    if tp > 1 and dist.is_initialized():
        sizes = {"tp": tp, "sh": sh, "sw": sw}
        mesh = replace(mesh, tp_group=_groups_along(sizes, ("tp",), mesh.rank),
                       group=_groups_along(sizes, ("sh", "sw"), mesh.rank))
    return mesh


def expert_mesh(ep: int) -> ExpertMesh:
    """An "ep" axis of `ep` ranks over the launched world: the world's
    ranks in consecutive runs of `ep` (the last axis of a row-major
    (world // ep, ep) mesh), each run one expert-parallel group."""
    world, rank = process_count(), process_index()
    if ep < 1 or world % ep:
        raise ValueError(f"ep {ep} does not divide the world of {world} processes")
    group = None if ep == world else _groups_along({"rest": world // ep, "ep": ep}, ("ep",),
                                                    rank)
    return ExpertMesh(ep, rank % ep, group)


_PLACEMENTS = ("shard_tensor_parallel", "shard_experts", "tensor_parallel_state_dict",
               "tensor_parallel_report", "check_tensor_parallel")


def __getattr__(name):
    # the tensor- and expert-parallel placements live in parallel/
    # tensor_parallel.py, which builds on the collectives here
    if name in _PLACEMENTS:
        from vaevar_tpu_torch.parallel import tensor_parallel

        return getattr(tensor_parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
