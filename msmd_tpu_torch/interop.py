"""Load parameters into the port's modules: the JAX package's trees and
the reference ``.pt`` checkpoints.

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

A reference checkpoint (``{args, model, style_enc, iter}``; reference:
training_script.py:227-233) is read with ``load_reference_pt`` and its
torch-named state dicts are mapped to that tree by
``reference_msmd_to_flax`` and ``reference_style_enc_to_flax``: the
port's own copy of ``msmd_tpu/interop/msmd_checkpoint.py:50-101`` and of
the helpers of ``msmd_tpu/interop/torch_params.py`` it uses.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

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


# ---------------------------------------------------------------------------
# reference .pt checkpoints
# ---------------------------------------------------------------------------

StateDict = Dict[str, np.ndarray]


def load_reference_pt(path) -> Tuple[dict, StateDict, StateDict, int]:
    """Read a reference ``.pt`` into (args, model state dict, style-encoder
    state dict, iteration), the state dicts as NumPy arrays."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=False)
    to_np = lambda sd: {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
                        for k, v in sd.items()}
    args = ckpt.get("args", {})
    if hasattr(args, "__dict__"):
        args = vars(args)
    return args, to_np(ckpt["model"]), to_np(ckpt["style_enc"]), int(ckpt.get("iter", 0))


def _linear(sd: StateDict, prefix: str) -> dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _conv1d(sd: StateDict, prefix: str) -> dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _norm(sd: StateDict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _packed_mha(sd: StateDict, prefix: str) -> dict:
    """torch ``nn.MultiheadAttention`` (packed in_proj) -> separate q/k/v."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd.get(f"{prefix}.in_proj_bias")
    e = w.shape[1]
    parts = {}
    for i, name in enumerate(["q_proj", "k_proj", "v_proj"]):
        parts[name] = {"kernel": np.ascontiguousarray(w[i * e:(i + 1) * e].T)}
        if b is not None:
            parts[name]["bias"] = b[i * e:(i + 1) * e]
    parts["out_proj"] = _linear(sd, f"{prefix}.out_proj")
    return parts


def _decoder_layer(sd: StateDict, prefix: str) -> dict:
    return {
        "self_attn": _packed_mha(sd, f"{prefix}.self_attn"),
        "cross_attn": _packed_mha(sd, f"{prefix}.multihead_attn"),
        "ffn": {"linear1": _linear(sd, f"{prefix}.linear1"), "linear2": _linear(sd, f"{prefix}.linear2")},
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "norm3": _norm(sd, f"{prefix}.norm3"),
    }


def _encoder_layer(sd: StateDict, prefix: str) -> dict:
    return {
        "self_attn": _packed_mha(sd, f"{prefix}.self_attn"),
        "ffn": {"linear1": _linear(sd, f"{prefix}.linear1"), "linear2": _linear(sd, f"{prefix}.linear2")},
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
    }


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _hf_audio_encoder(sd: StateDict, n_layers: Optional[int] = None, n_convs: Optional[int] = None) -> dict:
    """A Hugging Face Wav2Vec2Model / HubertModel state dict -> the audio
    encoder's tree, with the weight-normed positional convolution folded
    ('g'/'v' or the parametrizations layout)."""
    if n_convs is None:
        n_convs = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("feature_extractor.conv_layers."))
    if n_layers is None:
        n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    p: dict = {"feature_extractor": {}, "feature_projection": {}, "encoder": {}}
    for i in range(n_convs):
        p["feature_extractor"][f"conv_{i}"] = _conv1d(sd, f"feature_extractor.conv_layers.{i}.conv")
    if "feature_extractor.conv_layers.0.layer_norm.weight" in sd:
        p["feature_extractor"]["group_norm"] = _norm(sd, "feature_extractor.conv_layers.0.layer_norm")
    p["feature_projection"]["layer_norm"] = _norm(sd, "feature_projection.layer_norm")
    p["feature_projection"]["projection"] = _linear(sd, "feature_projection.projection")
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in sd:
        g, v = sd[f"{base}.weight_g"], sd[f"{base}.weight_v"]
        w = g * v / np.linalg.norm(v, axis=(0, 1), keepdims=True)
    elif f"{base}.parametrizations.weight.original0" in sd:
        g, v = sd[f"{base}.parametrizations.weight.original0"], sd[f"{base}.parametrizations.weight.original1"]
        w = g * v / np.linalg.norm(v, axis=(0, 1), keepdims=True)
    else:
        w = sd[f"{base}.weight"]
    p["encoder"]["pos_conv_embed"] = {
        "conv": {"kernel": np.ascontiguousarray(w.transpose(2, 1, 0)), "bias": sd[f"{base}.bias"]}
    }
    p["encoder"]["layer_norm"] = _norm(sd, "encoder.layer_norm")
    for i in range(n_layers):
        layer = f"encoder.layers.{i}"
        p["encoder"][f"layers_{i}"] = {
            **{n: _linear(sd, f"{layer}.attention.{n}") for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": _norm(sd, f"{layer}.layer_norm"),
            "intermediate_dense": _linear(sd, f"{layer}.feed_forward.intermediate_dense"),
            "output_dense": _linear(sd, f"{layer}.feed_forward.output_dense"),
            "final_layer_norm": _norm(sd, f"{layer}.final_layer_norm"),
        }
    if "masked_spec_embed" in sd:
        p["masked_spec_embed"] = sd["masked_spec_embed"]
    return p


def reference_msmd_to_flax(sd: StateDict, cfg) -> dict:
    """The reference ``MSMD.state_dict()`` (NumPy) -> the MSMD params tree."""
    p: dict = {
        "audio_encoder": _hf_audio_encoder(_strip_prefix(sd, "audio_encoder")),
        "audio_feature_map": _linear(sd, "audio_feature_map"),
        "start_motion_feat": sd["start_motion_feat"],
        "start_audio_feat": sd["start_audio_feat"],
    }
    for name in ("null_style_feat", "null_audio_feat"):
        if name in sd:
            p[name] = sd[name]
    dn: dict = {
        "diff_step_map": {"linear1": _linear(sd, "denoising_net.diff_step_map.0"),
                          "linear2": _linear(sd, "denoising_net.diff_step_map.2")},
    }
    if "denoising_net.PE" in sd:
        dn["PE"] = sd["denoising_net.PE"]
    dn["person_proj"] = _linear(sd, "denoising_net.person_proj")
    dn["feature_proj"] = _linear(sd, "denoising_net.feature_proj")
    dn["transformer"] = {f"layers_{i}": _decoder_layer(sd, f"denoising_net.transformer.layers.{i}")
                         for i in range(cfg.n_layers)}
    for k in range(cfg.num_of_basis):
        dn[f"static_feature_mapping_{k}"] = {
            "linear1": _linear(sd, f"denoising_net.static_feature_mapping.{k}.0"),
            "linear2": _linear(sd, f"denoising_net.static_feature_mapping.{k}.2"),
        }
    dn["motion_dec_1"] = _linear(sd, "denoising_net.motion_dec.0")
    dn["motion_dec_2"] = _linear(sd, "denoising_net.motion_dec.2")
    p["denoising_net"] = dn
    return p


def reference_style_enc_to_flax(sd: StateDict) -> dict:
    """The reference ``StyleEncoder_VAE2.state_dict()`` (NumPy) -> the
    style encoder's params tree."""
    return {
        "input_layers": {
            "conv_0": _conv1d(sd, "input_layers.1"),
            "norm_0": _norm(sd, "input_layers.5"),
            "conv_1": _conv1d(sd, "input_layers.7"),
            "norm_1": _norm(sd, "input_layers.11"),
        },
        "encoder": _encoder_layer(sd, "encoder"),
        "out_conv_0": _conv1d(sd, "output_layers.1"),
        "out_norm": _norm(sd, "output_layers.5"),
        "out_conv_1": _conv1d(sd, "output_layers.7"),
    }
