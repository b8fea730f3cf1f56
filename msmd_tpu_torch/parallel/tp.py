"""Tensor parallelism as Megatron column / row sharding of the dense layers
(the port of ``msmd_tpu/parallel/tp.py``).

The rules are the JAX package's, by module name:

- column-parallel (output rows of the weight and the bias sharded, the
  activations after it sharded): ``q_proj``, ``k_proj``, ``v_proj`` and
  the first FFN / MLP product (``linear1``, ``intermediate_dense``);
- row-parallel (input columns of the weight sharded): ``out_proj`` and
  the second product (``linear2``, ``output_dense``); the partial
  products are summed over the ``model`` group, then the replicated bias
  is added;
- everything else (LayerNorms, convolutions, embeddings, the other dense
  layers) replicated.

They reach the denoiser's layers, its step-embedding and style-basis
MLPs, HuBERT's layers and the style encoder's layer, as the JAX rules
reach every leaf of the train state. A dimension that ``tp`` does not
divide stays replicated (``tp_spec``'s guard). JAX's GSPMD shards the
columns of an attention projection wherever the width divides, splitting
a head if it must; the port's attention reshapes by head (and the
denoiser's self-attention concatenates q, k and v into one product), so
it shards an attention only where ``n_heads % tp == 0`` and replicates
its four projections otherwise. The numbers are the same either way.

A sharded ``Dense`` carries a ``TPShard``: column-parallel layers pass
their input through ``copy_to_group`` (the identity forward, the sum of
the input gradient over the group backward), row-parallel layers through
``reduce_from_group`` (the sum forward, the identity backward), as
Megatron's f and g. Dropout of a sharded activation draws the whole
tensor's mask and keeps the rank's slice (``layers.dropout``), so the
masks are those of one device. Adam's moments are made for the local
shard and live beside it, as JAX's ``mu`` / ``nu`` follow their
parameters. The replicated parameters' gradients are equal on the ranks
of a model group as long as every kernel on the path sums in a fixed
order (``layers.Conv1d`` takes cuDNN's deterministic weight gradient for
that), so the replicas take the same update with no collective of their
own.

Under ``tp > 1`` the whole-weight kernels stay closed (K1-K4, K6-K9; the
models read ``tp_sharded``): they take a layer's unsharded weights, and
JAX too applies tensor parallelism to its XLA path only. That is a gate
on the layout, fixed when the model is sharded, before any launch. K5
and K5 bwd take replicated FLAME constants and run on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from msmd_tpu_torch.parallel.mesh import full_tensor

COL_MODULES = ("q_proj", "k_proj", "v_proj", "linear1", "intermediate_dense")
ROW_MODULES = ("out_proj", "linear2", "output_dense")
ATTENTION = ("q_proj", "k_proj", "v_proj", "out_proj")


class TPShard:
    """One dense layer's place in a tensor-parallel group: ``mode`` "col"
    or "row", and this rank's index among ``size``. A deep copy of a
    sharded module shares it (a process group cannot be copied)."""

    def __init__(self, mode: str, group, rank: int, size: int):
        self.mode, self.group, self.rank, self.size = mode, group, rank, size

    def __deepcopy__(self, memo):
        return self

    def dim(self, leaf: str) -> Optional[int]:
        """The sharded dimension of the layer's ``weight`` or ``bias``."""
        if leaf == "weight":
            return 0 if self.mode == "col" else 1
        return 0 if self.mode == "col" else None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, summed in f32, in ``x``'s dtype."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def copy_to_group(x: torch.Tensor, shard: TPShard) -> torch.Tensor:
    return _CopyToGroup.apply(x, shard.group)


def reduce_from_group(x: torch.Tensor, shard: TPShard) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, shard.group)


def _heads(parent: nn.Module) -> Optional[int]:
    return getattr(parent, "n_heads", None)


def tp_spec(name: str, shape, tp_size: int, n_heads: Optional[int] = None) -> Optional[int]:
    """The sharded dimension of the parameter ``name`` (``...q_proj.weight``,
    torch layout (out, in)) of that ``shape`` under ``tp_size``-way tensor
    parallelism, or None (replicated): ``tp_spec`` of the JAX package in
    torch's layout, plus the head guard (``n_heads``: the heads of the
    attention a projection belongs to)."""
    parts = name.split(".")
    if tp_size <= 1 or len(parts) < 2:
        return None
    mod, leaf = parts[-2], parts[-1]
    if mod in ATTENTION and n_heads is not None and n_heads % tp_size:
        return None
    if leaf == "weight" and len(shape) == 2:
        if mod in COL_MODULES and shape[0] % tp_size == 0:
            return 0
        if mod in ROW_MODULES and shape[1] % tp_size == 0:
            return 1
    if leaf == "bias" and mod in COL_MODULES and len(shape) == 1 and shape[0] % tp_size == 0:
        return 0
    return None


def _plan(module: nn.Module, tp_size: int) -> Iterator[Tuple[str, nn.Linear, str]]:
    """(name, layer, mode) of every dense layer that ``tp_size`` shards."""
    for pname, parent in module.named_modules():
        for cname, child in parent.named_children():
            if not isinstance(child, nn.Linear) or cname not in COL_MODULES + ROW_MODULES:
                continue
            full = f"{pname}.{cname}" if pname else cname
            if tp_spec(f"{full}.weight", tuple(child.weight.shape), tp_size, _heads(parent)) is not None:
                yield full, child, "col" if cname in COL_MODULES else "row"


def shard_plan(module: nn.Module, tp_size: int) -> Dict[str, int]:
    """{parameter name: sharded dimension} of what ``tp_size`` shards in
    ``module`` (the rest is replicated)."""
    out = {}
    for name, layer, mode in _plan(module, tp_size):
        shard = TPShard(mode, None, 0, tp_size)
        for leaf in ("weight", "bias"):
            if getattr(layer, leaf) is not None and shard.dim(leaf) is not None:
                out[f"{name}.{leaf}"] = shard.dim(leaf)
    return out


def shard_model(module: nn.Module, group, rank: int, size: int) -> int:
    """Shard ``module``'s dense layers in place over the tensor-parallel
    ``group`` (this process is ``rank`` of ``size``): each sharded layer
    keeps its slice as new parameters (build the optimizer after this).
    Marks every submodule ``tp_sharded``. Returns the count of layers
    sharded."""
    if size <= 1:
        return 0
    n = 0
    for _, layer, mode in list(_plan(module, size)):
        shard = TPShard(mode, group, rank, size)
        for leaf in ("weight", "bias"):
            p = getattr(layer, leaf)
            d = shard.dim(leaf)
            if p is None or d is None:
                continue
            local = nn.Parameter(_slice(p.detach(), d, shard).clone(), requires_grad=p.requires_grad)
            setattr(layer, leaf, local)
        if mode == "col":
            layer.out_features //= size
        else:
            layer.in_features //= size
        layer.tp = shard
        n += 1
    for m in module.modules():
        m.tp_sharded = n > 0
    return n


def count_tp_sharded(module: nn.Module) -> int:
    """Parameters sharded over the model group (to assert that tensor
    parallelism engaged rather than replicating everything)."""
    return len(param_shards(module))


def is_sharded(module: nn.Module) -> bool:
    return getattr(module, "tp_sharded", False)


def _slice(t: torch.Tensor, dim: int, shard: TPShard) -> torch.Tensor:
    n = t.shape[dim] // shard.size
    return t.narrow(dim, shard.rank * n, n)


def param_shards(module: nn.Module) -> List[Tuple[nn.Parameter, int, TPShard]]:
    """(parameter, sharded dimension, shard) of every sharded parameter."""
    out = []
    for m in module.modules():
        shard = getattr(m, "tp", None)
        if isinstance(shard, TPShard):
            for leaf in ("weight", "bias"):
                p, d = getattr(m, leaf), shard.dim(leaf)
                if p is not None and d is not None:
                    out.append((p, d, shard))
    return out


def whole(local: torch.Tensor, dim: int, shard: TPShard) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's slice along
    ``dim`` (``mesh.full_tensor``)."""
    return full_tensor(local, dim, shard.group, shard.rank, shard.size)


def local_slice(full: torch.Tensor, dim: int, shard: TPShard) -> torch.Tensor:
    return _slice(full, dim, shard).clone()


@contextlib.contextmanager
def gathered(*modules: nn.Module):
    """Inside, every sharded parameter of ``modules`` holds its whole
    tensor (for checkpoints, and to load whole tensors); on exit each
    keeps its rank's slice of it, as changed inside. The parameters stay
    the same objects, so the optimizer keeps them. Every rank of a group
    enters together."""
    shards = [s for m in modules for s in param_shards(m)]
    with torch.no_grad():
        for p, d, shard in shards:
            p.data = whole(p.data, d, shard)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, d, shard in shards:
                p.data = local_slice(p.data, d, shard)
