"""Sharding rules and the collectives that keep them — the port of
``wav2letter_tpu/parallel/sharding.py``.

Batches are split over the data axis, parameters replicated or, under tensor
parallelism, column-split over the model axis by JAX's size rule
(:func:`param_spec`). GSPMD inserts the collectives in the JAX package; here
they are written out:

* :func:`replicate` broadcasts parameters from rank 0;
* every rank of a model group holds the rows of its data index (the datasets
  are split ``data_index::n_data``, :func:`dataset_shard`), so a batch is
  placed on the rank's one device as it is (:func:`shard_batch`);
* a layer with a sharded weight computes its own output columns and gathers
  them over the model group (:func:`gather_columns`), or, where the split
  axis is summed over (a conv's time taps), its partial output and sums it
  over the group (:func:`reduce_from_model`); the replicated input enters
  through :func:`enter_model_region`, whose backward sums the partial input
  gradients of the model group. The rest of the net sees the replicated
  math;
* :func:`all_reduce_grads` sums gradients over the data axis, and
  :func:`global_norm` counts each shard once.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .mesh import MODEL_AXIS, Mesh

Spec = Tuple[Any, ...]  # JAX's PartitionSpec as a tuple: () replicates


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` as rank 0 holds it."""
    if mesh.distributed:
        with torch.no_grad():
            for t in itertools.chain(module.parameters(), module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def dataset_shard(mesh: Mesh) -> Tuple[int, int]:
    """(world_rank, world_size) for the datasets: the data index and the
    data axis, so the ranks of a model group read the same rows."""
    return mesh.data_index, mesh.spec.n_data


def shard_batch(mesh: Mesh, batch: Dict[str, Any], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch, the fields an update reads, on
    its device: the audio, or the features a host featurizer made of it. The
    dataset already holds only them: this is a copy."""
    inputs = ("feats", "feat_len") if "feats" in batch else ("audio", "audio_len")
    return {k: torch.as_tensor(batch[k]).to(device)
            for k in inputs + ("target", "target_len", "row_mask")}


def to_host_local(mesh: Mesh, x: torch.Tensor) -> np.ndarray:
    """This rank's rows of a step output (inverse of :func:`shard_batch`)."""
    return x.detach().cpu().numpy()


# JAX's size rule; the tests lower it so that narrow layers split
MIN_SHARD_SIZE = 2**20


def param_spec(path: str, x: torch.Tensor, min_shard_size: Optional[int] = None) -> Spec:
    """JAX's rule: params of >= 2 dims and >= ``min_shard_size`` elements
    split their last axis over the model axis; the rest replicate. The port's
    params have JAX's layouts, so the axis is JAX's: the output features of a
    (in, out) ``Linear``, ``WNLinear`` ``v`` or ``Dense`` kernel, an
    ``Embedding``'s features, an OIHW conv weight's time taps."""
    if min_shard_size is None:
        min_shard_size = MIN_SHARD_SIZE
    shape = tuple(x.shape)
    if len(shape) < 2 or int(np.prod(shape)) < min_shard_size:
        return ()
    return (None,) * (len(shape) - 1) + (MODEL_AXIS,)


def _columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = x.shape[-1] // mesh.spec.n_model
    j = mesh.model_index
    return x[..., j * n:(j + 1) * n]


def split_plan(model: nn.Module, n_model: int) -> Dict[str, Tuple[nn.Module, str, Spec]]:
    """The params that tensor parallelism over ``n_model`` ranks splits, as
    JAX decides: :func:`param_spec`'s, where the model axis divides the last
    axis (the others stay whole). Maps each full name to (owning module,
    param name, spec); a module that cannot compute on a shard (no
    ``TP_PARAMS``) raises."""
    plan = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            spec = param_spec(name, p)
            if not spec or p.shape[-1] % n_model:
                continue
            full = f"{mod_name}.{name}" if mod_name else name
            if name not in getattr(mod, "TP_PARAMS", ()):
                raise NotImplementedError(
                    f"tensor parallelism of {full} ({type(mod).__name__}) is not in the "
                    "port: this module cannot compute on a shard of it")
            plan[full] = (mod, name, spec)
    return plan


def shard_params(mesh: Mesh, model: nn.Module, tensor_parallel: bool = False
                 ) -> Dict[str, Spec]:
    """Replicate ``model``, then under tensor parallelism keep only this
    rank's part of the last axis of every param :func:`split_plan` names;
    the owning module gets ``tp = mesh``. Every module a recipe reaches at
    full width can compute on its part. Returns the specs of the split
    params."""
    replicate(mesh, model)
    if mesh.spec.n_model == 1 or not tensor_parallel:
        return {}
    sharded = {}
    for full, (mod, name, spec) in split_plan(model, mesh.spec.n_model).items():
        p = getattr(mod, name)
        p.data = _columns(p.data, mesh).contiguous()
        mod.tp = mesh
        sharded[full] = spec
    return sharded


def _all_gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.spec.n_model)]
    dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=-1)


def gather_full(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A column shard gathered to its full shape (collective over the model
    group), for checkpoints."""
    return _all_gather_last(x.detach(), mesh)


class _GatherColumns(torch.autograd.Function):
    """Forward: all-gather the model group's columns. Backward: this rank's
    columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _columns(g, ctx.mesh).contiguous(), None


class _EnterModelRegion(torch.autograd.Function):
    """Forward: identity. Backward: the sum over the model group of the
    partial gradients that each rank's shard contributes."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the sum over the model group of each rank's partial value.
    Backward: identity, since what follows is replicated and every rank
    holds the same gradient of the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.model_group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherColumns.apply(x, mesh)


def enter_model_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _EnterModelRegion.apply(x, mesh)


def column_parallel(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w`` where ``w`` holds this rank's columns under tensor
    parallelism (``mesh`` not None): the full product on every rank."""
    if mesh is None:
        return x @ w
    return gather_columns(enter_model_region(x, mesh) @ w, mesh)


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model group, in place (no autograd)."""
    dist.all_reduce(x, group=mesh.model_group)
    return x


def all_reduce_grads(mesh: Mesh, replicated: List[torch.Tensor],
                     sharded: List[torch.Tensor]) -> None:
    """Sum gradients over the data axis, in place, in one collective a kind.
    Replicated gradients are summed over the whole world and divided by the
    model axis: the ranks of a model group computed the same values (up to
    the rounding of atomics on the card), and the mean keeps their replicas
    bit-identical. Shards are summed over their data group."""
    if not mesh.distributed:
        return
    for grads, group, div in ((replicated, None, mesh.spec.n_model),
                              (sharded, mesh.data_group, 1)):
        if not grads:
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if div != 1:
            flat /= div
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


def global_norm(mesh: Mesh, replicated: List[torch.Tensor],
                sharded: List[torch.Tensor]) -> torch.Tensor:
    """The global gradient norm, each replicated leaf and each shard counted
    once: the shards' norms are gathered over the model group in rank order,
    so every rank gets the same bits."""
    norms = torch.stack(torch._foreach_norm([g.float() for g in replicated + sharded]))
    if sharded and mesh.distributed:
        k = len(replicated)
        norms = torch.cat([norms[:k], _all_gather_last(norms[k:], mesh)])
    return torch.linalg.vector_norm(norms)
