"""The ranks of a multi-process run and the collectives between them.

Counterpart of gdm_tpu/parallel/mesh.py and of the mesh half of
gdm_tpu/parallel/sp.py (``make_mesh_2d``).  One process per card (NCCL)
or per CPU rank (gloo); the ranks form a (data, model) grid exactly as
``make_mesh_2d`` reshapes its devices: rank = d * model_shards + k.

  * the ranks of one *model row* (same d) hold the same batch rows and
    split the mesh columns of the similarity between them (parallel/sp.py);
  * the ranks of one *data column* (same k) hold different batch rows:
    the batch-norm moments, the losses' batch means and (with every
    other rank) the gradients are reduced over them.

Gradient scale.  Every cross-rank dependency of the loss goes through
:func:`all_reduce_sum`, whose backward all-reduces the cotangent again,
and every rank backs out the same (global) loss.  The backward pass of
all ranks together is then the exact gradient of the sum of the W = world
copies of the loss, taken with respect to each rank's own copy of the
parameters; the gradient of the loss itself is the mean of the ranks'
gradients (:func:`average_gradients`), for parameters replicated on every
rank.  A rank's gradient alone is no such thing: its own batch rows'
contribution is scaled by the data-column size, its mesh columns' by the
model-row size (tests/test_torch_sp.py pins both).

With no process group (one rank), nothing here communicates and every
caller computes bit for bit what it computed before.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

# how long a rank waits in a collective before the run fails: the other
# ranks wait for rank 0's validation (train --eval-every) of a test split
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass
class Grid:
    """This rank's place in the (data, model) grid and its two groups.

    ``data_group`` reduces over the ranks of this rank's data column and
    ``model_group`` over those of its model row; either is None where it
    holds this rank alone, so nothing is reduced there."""

    rank: int = 0
    world: int = 1
    model_shards: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_shards

    @property
    def data_size(self) -> int:
        return self.world // self.model_shards

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_shards


def rank_device(device: torch.device) -> torch.device:
    """The card of this process in the torchrun layout: ``cuda`` without
    an index becomes ``cuda:$LOCAL_RANK`` (0 when unset); the CPU and an
    explicit index stay."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def init_process_group(device: torch.device) -> None:
    """Join the process group of the torchrun environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL for a card, gloo for the
    CPU.  A group already made by the caller is used as it is."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)


def _group(ranks: list[int], world: int):
    """The group of ``ranks``: None for one rank, the default group for
    all of them.  Every rank must make the same calls in the same order
    (dist.new_group)."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_grid(model_shards: int = 1) -> Grid:
    """This process's Grid: one rank without a process group, else the
    group's ranks as a (world // model_shards, model_shards) grid."""
    if not dist.is_initialized():
        if model_shards != 1:
            raise ValueError(f"{model_shards} model shards need as many "
                             "ranks; there is one")
        return Grid()
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % model_shards:
        raise ValueError(f"{model_shards} model shards do not divide "
                         f"{world} ranks")
    n_data = world // model_shards
    d, k = divmod(rank, model_shards)
    data_group = model_group = None
    for kk in range(model_shards):          # every rank makes every group
        g = _group([dd * model_shards + kk for dd in range(n_data)], world)
        if kk == k:
            data_group = g
    for dd in range(n_data):
        g = _group([dd * model_shards + kk for kk in range(model_shards)],
                   world)
        if dd == d:
            model_group = g
    return Grid(rank, world, model_shards, data_group, model_group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangents over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (JAX's psum); ``x``
    itself for no group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group`` (JAX's pmax), without gradient."""
    x = x.detach().clone()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min over ``group`` (JAX's pmin), without gradient."""
    x = x.detach().clone()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


@torch.no_grad()
def average_gradients(params, grid: Grid) -> None:
    """Replace each parameter's gradient by its mean over every rank (see
    the module docstring for why the mean over all ranks, model rows
    included, is the gradient of the loss).  One all-reduce of one flat
    buffer; a parameter without a gradient counts as zeros."""
    if grid.world == 1:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= grid.world
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, grid: Grid) -> None:
    """Rank 0's parameters and buffers onto every rank."""
    if grid.world == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def all_gather_host(obj, grid: Grid) -> list:
    """Every rank's python object, in rank order (gdm_tpu/parallel/
    mesh.py all_gather_host: the evaluator's and infer's gather); one
    rank gives [obj]."""
    if grid.world == 1:
        return [obj]
    out = [None] * grid.world
    dist.all_gather_object(out, obj)
    return out


def attach(model: torch.nn.Module, grid: Grid) -> None:
    """Make ``model``'s training forward global over ``grid``: its batch
    norms take the data column's moments (BatchNorm.group), and its
    losses reduce over the data column and split the mesh columns over
    the model row (the models' ``grid``).  One rank changes nothing."""
    from gdm_tpu_torch.models.layers import BatchNorm

    model.grid = grid
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = grid.data_group
