"""Tensor- and expert-parallel placements: the port of the JAX package's
`shard_tensor_parallel` and `shard_experts` (vaevar_tpu/parallel/mesh.py:
150-197), reachable from parallel/mesh.py.

JAX only places the weights (qkv/fc1 columns and proj/fc2 rows over "tp" in
contiguous blocks, the expert banks over "ep") and lets GSPMD insert the
reshards and sums. Torch has no GSPMD, so the port runs real Megatron
layers, on one rank's slice of the weights:

- `shard_tensor_parallel(model, mesh)` splits every block of an LGUnet's LG
  stack (`net.layers.*.blocks.*`) over the mesh's tp group. Attention is
  split by head: a rank keeps the q, k and v rows of `attn.qkv` for its
  heads (JAX's contiguous 3C/tp columns would cut across the (3, heads,
  head_dim) reshape), their columns of the relative-position bias table (the
  rope tables are per head width, the same for every head), their rows of
  `qB` under LoRA, and their input columns of `attn.proj`. The MLP keeps a
  contiguous block of fc1's hidden units and fc2's matching input columns.
  Each branch starts at `copy_to_ranks` and ends at `sum_over_ranks` over
  the tp group (`_RowParallel`): the row-parallel partials are summed in f32
  and the bias added once after the sum, then cast once to the compute type,
  so a bf16 model rounds its output once, as one process does. A stage whose
  heads tp does not divide keeps its attention whole (replicated: every
  rank computes it) and splits its MLP alone; a hidden width tp does not
  divide raises. `tensor_parallel_report` says which stage split what,
  `tensor_parallel_state_dict` gathers the slices back into the full
  reference keys.
- `shard_experts(module, mesh)` keeps a contiguous block of E / ep experts
  of each `models/zoo.py::MoEDense` bank; the router, its losses and the
  capacity mask stay whole, and only the combine's sum over the experts
  crosses the ep group (ops/moe.py::moe_combine).

The copy and the sum carry gradients and jvp tangents (parallel/mesh.py),
so a placed decoder runs inside the solve's jvp-zoom linesearch. Every rank
of a group receives the same sum, so the ranks of a tp group compute the
same activations bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from vaevar_tpu_torch.parallel.mesh import _all_gather, copy_to_ranks, sum_over_ranks


class _RowParallel(nn.Module):
    """A block's attention or MLP branch on a tp rank: `local` is the branch
    with this rank's heads or hidden units, `features` its method up to the
    row-parallel layer `out` (attend/proj, hidden/fc2). The input is copied
    into the branch and the partial outputs summed over `group`, in f32,
    before `out`'s bias is added once."""

    def __init__(self, local: nn.Module, features: str, out: str, group, whole: int,
                 split: int):
        super().__init__()
        self.local = local
        self.features, self.out = features, out
        self.group = group
        self.whole, self.split = whole, split  # heads or hidden units, whole and per rank

    def forward(self, x):
        y = getattr(self.local, self.features)(copy_to_ranks(x, self.group))
        lin = getattr(self.local, self.out)
        dt = self.local.dtype or torch.promote_types(y.dtype, lin.weight.dtype)
        part = F.linear(y.to(dt).float(), lin.weight.to(dt).float())
        return (sum_over_ranks(part, self.group) + lin.bias.to(dt).float()).to(dt)


def _narrow(lin: nn.Linear, rows=None, cols=None) -> nn.Linear:
    """A Linear holding the `rows` (output features, a list of slices) and
    `cols` (input features, a slice) of `lin`; its bias is sliced with the
    rows, and whole without them."""
    w = lin.weight
    if rows is not None:
        w = torch.cat([w[r] for r in rows])
    if cols is not None:
        w = w[:, cols]
    out = nn.Linear(w.shape[1], w.shape[0], bias=lin.bias is not None,
                    device=w.device, dtype=w.dtype)
    out.weight = nn.Parameter(w.clone(), requires_grad=lin.weight.requires_grad)
    if lin.bias is not None:
        b = torch.cat([lin.bias[r] for r in rows]) if rows is not None else lin.bias
        out.bias = nn.Parameter(b.clone(), requires_grad=lin.bias.requires_grad)
    return out


def _place_attention(attn, tp: int, index: int):
    """attn narrowed in place to heads [index h/tp, (index + 1) h/tp)."""
    hl, hd = attn.num_heads // tp, attn.head_dim
    dim = attn.num_heads * hd
    cols = slice(index * hl * hd, (index + 1) * hl * hd)
    attn.qkv = _narrow(attn.qkv, rows=[slice(i * dim + cols.start, i * dim + cols.stop)
                                       for i in range(3)])
    attn.proj = _narrow(attn.proj, cols=cols)
    if attn.lora_rank > 0:
        attn.qB = _narrow(attn.qB, rows=[cols])
    if attn.attn_type == "relbias":
        table = attn.relative_position_bias_table
        attn.relative_position_bias_table = nn.Parameter(
            table[:, index * hl:(index + 1) * hl].clone(), requires_grad=table.requires_grad)
    attn.num_heads = hl


def _place_mlp(mlp, tp: int, index: int):
    hl = mlp.fc1.out_features // tp
    units = slice(index * hl, (index + 1) * hl)
    mlp.fc1 = _narrow(mlp.fc1, rows=[units])
    mlp.fc2 = _narrow(mlp.fc2, cols=units)


def check_tensor_parallel(cfg, tp: int):
    """Raise ValueError, naming the layer, where tp does not divide the LG
    hidden width of an LGUnet config: the placement's one refusal, checked
    before a model is built."""
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    if hidden % tp:
        raise ValueError(f"net.layers.*.blocks.*.mlp: hidden width {hidden} does not divide "
                         f"by tp {tp}")


def _blocks(model, scope):
    from vaevar_tpu_torch.models.lgunet import Block

    return [(f"{scope}.{name}", m) for name, m in model.get_submodule(scope).named_modules()
            if isinstance(m, Block)]


def shard_tensor_parallel(model: nn.Module, mesh, scope: str = "net") -> nn.Module:
    """Megatron-style tensor parallelism of every Block under `scope` (an
    LGUnet's LG stack) over `mesh`'s tp group (parallel/mesh.SpatialMesh;
    tp 1 places nothing): each block keeps this rank's slice of its
    attention heads and hidden units, as the module docstring says; a
    stage whose heads tp does not divide keeps its attention whole. Places
    the model in place and returns it; raises ValueError, naming the layer,
    where tp does not divide a hidden width. Load the full weights first,
    then place them."""
    tp, index, group = mesh.tp, mesh.coords["tp"], mesh.tp_group
    if tp == 1:
        return model
    blocks = _blocks(model, scope)
    for name, blk in blocks:
        hidden = blk.mlp.fc1.out_features
        if hidden % tp:
            raise ValueError(f"{name}.mlp: hidden width {hidden} does not divide by tp {tp}")
    for name, blk in blocks:
        heads = blk.attn.num_heads
        if heads % tp == 0:
            _place_attention(blk.attn, tp, index)
            blk.attn = _RowParallel(blk.attn, "attend", "proj", group, heads, heads // tp)
        hidden = blk.mlp.fc1.out_features
        _place_mlp(blk.mlp, tp, index)
        blk.mlp = _RowParallel(blk.mlp, "hidden", "fc2", group, hidden, hidden // tp)
    return model


def is_tensor_parallel(model: nn.Module) -> bool:
    """Whether `model` holds a branch `shard_tensor_parallel` placed: its
    forward then runs collectives over the tp group."""
    return any(isinstance(m, _RowParallel) for m in model.modules())


def tensor_parallel_report(model: nn.Module, scope: str = "net") -> list:
    """One line per stage under `scope` of a placed model: its blocks'
    attention (split heads per rank, or whole) and MLP (hidden units per
    rank)."""
    stages = {}
    for name, blk in _blocks(model, scope):
        stages.setdefault(name.rsplit(".blocks.", 1)[0], []).append(blk)
    lines = []
    for stage, blks in stages.items():
        attn, mlp = blks[0].attn, blks[0].mlp
        if isinstance(attn, _RowParallel):
            a = f"attention {attn.split} of {attn.whole} heads per rank"
        else:
            h = attn.num_heads
            a = f"attention whole ({h} head{'s' * (h > 1)} on every rank)"
        m = (f"mlp {mlp.split} of {mlp.whole} hidden units per rank"
             if isinstance(mlp, _RowParallel) else "mlp whole")
        lines.append(f"{stage} ({len(blks)} block{'s' * (len(blks) > 1)}): {a}, {m}")
    return lines


def tensor_parallel_state_dict(model: nn.Module, scope: str = "net") -> dict:
    """The state dict of a placed model under the full model's (reference)
    keys, every rank's slices all-gathered over the tp group: a collective,
    so every rank of the group calls it. The unplaced model's state dict,
    bit for bit, for a model placed from it."""
    out = {key.replace(".local.", "."): v for key, v in model.state_dict().items()}
    for name, blk in _blocks(model, scope):
        for branch in (blk.attn, blk.mlp):
            if not isinstance(branch, _RowParallel):
                continue
            prefix = f"{name}.{'attn' if branch.out == 'proj' else 'mlp'}."
            for pname, p in branch.local.named_parameters():
                parts = [t.to(p.device) for t in _all_gather(p, branch.group)]
                out[prefix + pname] = _join(branch, pname, parts)
    return out


def _join(branch: _RowParallel, pname: str, parts: list) -> torch.Tensor:
    """The whole parameter from every tp rank's slice, in rank order."""
    if pname in ("proj.bias", "fc2.bias"):  # whole on every rank
        return parts[0]
    if pname in ("proj.weight", "fc2.weight", "relative_position_bias_table"):
        return torch.cat(parts, dim=1)
    if pname.startswith("qkv."):  # each rank's rows are its [q; k; v]
        return torch.cat([c for i in range(3) for c in (p.chunk(3)[i] for p in parts)])
    if pname in ("fc1.weight", "fc1.bias", "qB.weight"):
        return torch.cat(parts)
    return parts[0]  # replicated (LoRA's qA)


# --- expert parallelism ------------------------------------------------------


class ExpertShard(NamedTuple):
    """A MoEDense bank's placement on an ep rank: its `experts` (a slice of
    the bank) and the ep `group` its combine sums over."""

    experts: slice
    group: object

    def copy(self, x):
        return copy_to_ranks(x, self.group)

    def sum(self, x):
        return sum_over_ranks(x, self.group)


def shard_experts(module: nn.Module, mesh) -> nn.Module:
    """Expert parallelism for every models/zoo.py::MoEDense in `module` over
    `mesh` (parallel/mesh.ExpertMesh): each keeps the contiguous block
    [index E/ep, (index + 1) E/ep) of its w1, b1, w2 and b2; the router and
    the rest stay whole. Every rank must draw the same router jitter (the
    same generator state, or router noise off). Places in place and
    returns the module."""
    from vaevar_tpu_torch.models.zoo import MoEDense

    for name, m in module.named_modules():
        if not isinstance(m, MoEDense):
            continue
        E = m.num_experts
        if E % mesh.ep:
            raise ValueError(f"{name or 'module'}: {E} experts do not divide by ep {mesh.ep}")
        n = E // mesh.ep
        experts = slice(mesh.index * n, (mesh.index + 1) * n)
        for pname in ("w1", "b1", "w2", "b2"):
            p = getattr(m, pname, None)
            if p is not None:
                setattr(m, pname, nn.Parameter(p[experts].clone(), requires_grad=p.requires_grad))
        m.expert_parallel = ExpertShard(experts, mesh.group)
    return module
