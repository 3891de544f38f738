"""Megatron-style tensor parallelism of the CLIP towers (the port's
counterpart of :mod:`t2igan.parallel.tp`).

The JAX package shards the towers' parameters over the ``model`` axis of a
2-D ``(data, model)`` mesh with ``PartitionSpec``s and lets GSPMD insert
the all-reduces:

=======================================  ====================================
JAX (``t2igan/parallel/tp.py``)          port
=======================================  ====================================
``_spec_for_path`` (:21)                 :func:`clip_tp_spec` (the same rules
                                         under the port's parameter names)
``clip_param_sharding`` (:48)            :func:`shard_tensor` of each
                                         parameter under its spec
``shard_clip_params`` (:55)              :func:`shard_clip_` (the modules
                                         replaced in place)
=======================================  ====================================

``qkv_proj`` and ``fc1`` are column-parallel: a rank keeps its heads' (or
its hidden units') output rows and computes its part of the activations
with no collective.  ``out_proj`` and ``fc2`` are row-parallel: a rank
keeps the matching input columns, its partial products are summed over the
model group by an autograd all_reduce, and the replicated bias is added
once, after the sum.  Embeddings, projections and layer norms are
replicated.

The port's ``qkv_proj`` stacks q, k and v on its output rows as
``(3, heads, head_dim)`` (``models/clip.py``), so a rank takes its heads
from each third (the JAX kernel is ``[d, 3, d]``, sharded on its last axis,
``t2igan/models/clip.py:81-82``); a contiguous ``1 / T`` of the rows would
be wrong.

Gradients follow :mod:`t2igan_torch.parallel.mesh`'s rule: every rank's
objective is the same global loss, the all_reduces' backward sums, so each
rank's gradient is ``W * T`` times its part of the global gradient;
:func:`all_reduce_grads_` sums the replicated parameters' gradients over
every rank and the shards' over the data group, and divides both by the
number of ranks.  ``clip%d.pth`` is written whole: :func:`gather_clip`
makes the whole module from the shards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from t2igan_torch.models.clip import ClipWithRegionHead, EncoderLayer
from t2igan_torch.parallel.mesh import DataMesh, sum_autograd

COLUMN, ROW = "column", "row"


def clip_tp_spec(name: str) -> Optional[Tuple[str, int]]:
    """How parameter ``name`` of :class:`ClipWithRegionHead` is split over
    the model axis: ``("column", 0)`` (output rows) for ``qkv_proj`` and
    ``fc1``, weight and bias; ``("row", 1)`` (input columns) for the
    weights of ``out_proj`` and ``fc2``; None (replicated) for everything
    else, the row-parallel biases included."""
    parts = name.split(".")
    if "qkv_proj" in parts or "fc1" in parts:
        return COLUMN, 0
    if ("out_proj" in parts or "fc2" in parts) and parts[-1] == "weight":
        return ROW, 1
    return None


def _split(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` with its split dimension first, as [parts, n, ...]: the three
    q/k/v thirds of ``qkv_proj`` in a leading axis of 3, else 1."""
    _, dim = clip_tp_spec(name)
    t = t.movedim(dim, 0)
    thirds = 3 if "qkv_proj" in name.split(".") else 1
    return t.reshape(thirds, t.shape[0] // thirds, *t.shape[1:])


def shard_tensor(name: str, t: torch.Tensor, index: int,
                 count: int) -> torch.Tensor:
    """Model rank ``index``'s part (of ``count``) of parameter ``name``
    (the whole tensor when replicated), as a new contiguous tensor."""
    if clip_tp_spec(name) is None:
        return t.detach().clone()
    _, dim = clip_tp_spec(name)
    parts = _split(name, t.detach())
    n = parts.shape[1] // count
    piece = parts[:, index * n:(index + 1) * n]
    return piece.reshape(-1, *piece.shape[2:]).movedim(0, dim).contiguous()


def _whole(name: str, shard: torch.Tensor, index: int, count: int,
           group) -> torch.Tensor:
    """The whole parameter from every model rank's ``shard``."""
    _, dim = clip_tp_spec(name)
    parts = _split(name, shard.detach())
    n = parts.shape[1]
    full = parts.new_zeros((parts.shape[0], n * count) + parts.shape[2:])
    full[:, index * n:(index + 1) * n] = parts
    dist.all_reduce(full, group=group)
    return full.reshape(-1, *full.shape[2:]).movedim(0, dim).contiguous()


class RowParallelLinear(nn.Module):
    """``y = sum over the model group of x_m W_m^T, + b``: the partial
    products are summed by an autograd all_reduce (its backward sums the
    ranks' gradients too) and the bias is added once."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = sum_autograd(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _column(lin: nn.Linear, name: str, index: int,
            count: int) -> nn.Linear:
    w = shard_tensor(name + ".weight", lin.weight, index, count)
    out = nn.Linear(w.shape[1], w.shape[0], bias=lin.bias is not None,
                    device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        if lin.bias is not None:
            out.bias.copy_(shard_tensor(name + ".bias", lin.bias, index,
                                        count))
    return out.requires_grad_(lin.weight.requires_grad)


def _row(lin: nn.Linear, name: str, index: int, count: int,
         group) -> RowParallelLinear:
    w = shard_tensor(name + ".weight", lin.weight, index, count)
    b = None if lin.bias is None else lin.bias.detach().clone()
    return RowParallelLinear(w, b, group).requires_grad_(
        lin.weight.requires_grad)


def _layers(clip: ClipWithRegionHead):
    for name, m in clip.named_modules():
        if isinstance(m, EncoderLayer):
            yield name, m


def shard_clip_(clip: ClipWithRegionHead, group) -> ClipWithRegionHead:
    """Shard every encoder layer of both towers over the model ``group``
    in place (this rank's index and the group's size from ``group``);
    parameter names stay, shapes shrink.  Raises ``ValueError`` when the
    group's size does not divide a tower's heads or MLP width."""
    index, count = dist.get_rank(group), dist.get_world_size(group)
    for tower in (clip.cfg.text, clip.cfg.vision):
        if tower.num_heads % count or tower.mlp_dim % count:
            raise ValueError(
                f"tensor parallelism over {count} ranks needs a head count "
                f"and MLP width divisible by {count}; this tower has "
                f"{tower.num_heads} heads and MLP {tower.mlp_dim}")
    for name, layer in _layers(clip):
        attn = layer.self_attn
        attn.num_heads //= count
        attn.qkv_proj = _column(attn.qkv_proj, f"{name}.self_attn.qkv_proj",
                                index, count)
        attn.out_proj = _row(attn.out_proj, f"{name}.self_attn.out_proj",
                             index, count, group)
        layer.fc1 = _column(layer.fc1, f"{name}.fc1", index, count)
        layer.fc2 = _row(layer.fc2, f"{name}.fc2", index, count, group)
    clip.tp_group = group
    return clip


def gather_clip(clip: ClipWithRegionHead) -> ClipWithRegionHead:
    """A whole (unsharded) copy of a module sharded by
    :func:`shard_clip_` (collective over its model group); the module
    itself when it is not sharded."""
    group = getattr(clip, "tp_group", None)
    if group is None:
        return clip
    index, count = dist.get_rank(group), dist.get_world_size(group)
    state = {n: (_whole(n, t, index, count, group)
                 if clip_tp_spec(n) else t.detach().clone())
             for n, t in clip.state_dict().items()}
    whole = ClipWithRegionHead(clip.cfg).to(clip.logit_scale.device)
    whole.load_state_dict(state)
    return whole.requires_grad_(clip.logit_scale.requires_grad)


def all_reduce_grads_(clip: ClipWithRegionHead, data: DataMesh) -> None:
    """The gradient of the global loss on every rank of a ``(data, model)``
    layout over the whole world (:func:`mesh_2d`): the replicated
    parameters' gradients summed over every rank, the shards' over
    ``data``'s group, both divided by the number of ranks."""
    total = data.world * dist.get_world_size(clip.tp_group)
    named = list(clip.named_parameters())
    data.all_reduce_grads_([p for n, p in named if clip_tp_spec(n)],
                           divisor=total)
    data.all_reduce_grads_([p for n, p in named if not clip_tp_spec(n)],
                           group=dist.group.WORLD, divisor=total)


def mesh_2d(mesh: DataMesh, model: int):
    """The ``(data, model)`` layout of ``mesh``'s ranks with ``model``
    ranks on the model axis (rank ``r`` at ``(r // model, r % model)``,
    as a ``(data, model)`` JAX mesh over the devices in order): returns
    the data axis as a :class:`DataMesh` (over a group of the ranks with
    this rank's model index) and the model group.  Every rank must call
    it (``new_group`` is collective)."""
    if mesh.world % model:
        raise ValueError(f"{mesh.world} ranks do not split into a model "
                         f"axis of {model}")
    data_n = mesh.world // model
    data_groups = [dist.new_group([d * model + m for d in range(data_n)],
                                  backend=mesh.backend)
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)],
                                   backend=mesh.backend)
                    for d in range(data_n)]
    d, m = divmod(mesh.rank, model)
    data = DataMesh(rank=d, world=data_n, local_index=d, local_count=data_n,
                    group=data_groups[m], device=mesh.device,
                    backend=mesh.backend)
    return data, model_groups[d]
