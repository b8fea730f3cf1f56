"""Load the JAX package's parameter trees into the port's modules.

``load_flax_params(module, tree)`` takes a Flax ``params`` tree given as
nested dicts of NumPy arrays (``jax.tree_util.tree_map(np.asarray,
variables["params"])`` on the JAX side), so this module needs no JAX.
The port's modules use the Flax names; a Flax child ``name_i`` maps to
element ``i`` of the ``nn.ModuleList`` called ``name`` (``layers_3`` ->
``layers[3]``, ``conv_0`` -> ``conv[0]``). Leaves are converted by kind:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in)
- Conv ``kernel`` (k, in/groups, out) -> ``weight`` (out, in/groups, k)
- LayerNorm / GroupNorm ``scale`` -> ``weight``; ``bias`` as it is
- any other array (PE, null and start embeddings) as it is

Every parameter of the module must be given and every leaf of the tree
must be used; a shape that does not match raises.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(.*)_(\d+)$")


def _child(module: nn.Module, name: str) -> nn.Module:
    sub = getattr(module, name, None)
    if isinstance(sub, nn.Module):
        return sub
    m = _INDEXED.match(name)
    if m:
        lst = getattr(module, m.group(1), None)
        if isinstance(lst, nn.ModuleList) and int(m.group(2)) < len(lst):
            return lst[int(m.group(2))]
    raise KeyError(f"{type(module).__name__} has no submodule for Flax name {name!r}")


def _convert(name: str, value: np.ndarray, param: torch.Tensor) -> np.ndarray:
    if name == "kernel" and value.ndim == 2:
        return value.T
    if name == "kernel" and value.ndim == 3:
        return np.transpose(value, (2, 1, 0))
    return value


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a Flax params tree (nested dicts of NumPy arrays) into
    ``module`` in place; returns the module."""
    params = dict(module.named_parameters())
    used = set()

    def walk(mod: nn.Module, prefix: str, node: Mapping):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(_child(mod, key), f"{prefix}{_child_path(mod, key)}.", value)
                continue
            pname = {"kernel": "weight", "scale": "weight"}.get(key, key)
            full = prefix + pname
            if full not in params:
                raise KeyError(f"no parameter {full!r} for Flax leaf {prefix}{key}")
            p = params[full]
            arr = _convert(key, np.asarray(value), p)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{full}: Flax shape {np.shape(value)} does not map to {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
            used.add(full)

    walk(module, "", tree)
    missing = sorted(set(params) - used)
    if missing:
        raise KeyError(f"parameters missing from the Flax tree: {missing}")
    return module


def _child_path(module: nn.Module, name: str) -> str:
    """The torch attribute path of Flax child ``name`` (``layers.3``)."""
    if isinstance(getattr(module, name, None), nn.Module):
        return name
    m = _INDEXED.match(name)
    return f"{m.group(1)}.{m.group(2)}"
