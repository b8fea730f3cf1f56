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

The way back, for the trainer's checkpoints: ``flax_tree(module)`` gives
a module's parameters as a Flax tree, and ``flax_to_reference_msmd`` /
``flax_to_reference_style_enc`` (the copy of ``msmd_checkpoint.py``
:104-246) give the reference names, buffers included.
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
    """A Hugging Face Wav2Vec2Model / HubertModel / WavLMModel state dict ->
    the audio encoder's tree, with the weight-normed positional
    convolution folded ('g'/'v' or the parametrizations layout). The
    "layer" conv front (a LayerNorm on every convolution) is told from the
    base one's single GroupNorm by ``conv_layers.1.layer_norm``; WavLM's
    gate (``gru_rel_pos_linear``, ``gru_rel_pos_const`` as (heads,)) and
    layer 0's bucket table (``rel_attn_embed``) are read where present."""
    if n_convs is None:
        n_convs = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("feature_extractor.conv_layers."))
    if n_layers is None:
        n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    p: dict = {"feature_extractor": {}, "feature_projection": {}, "encoder": {}}
    for i in range(n_convs):
        p["feature_extractor"][f"conv_{i}"] = _conv1d(sd, f"feature_extractor.conv_layers.{i}.conv")
    if "feature_extractor.conv_layers.1.layer_norm.weight" in sd:
        for i in range(n_convs):
            p["feature_extractor"][f"layer_norm_{i}"] = _norm(sd, f"feature_extractor.conv_layers.{i}.layer_norm")
    elif "feature_extractor.conv_layers.0.layer_norm.weight" in sd:
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
        lp, attn = p["encoder"][f"layers_{i}"], f"{layer}.attention"
        if f"{attn}.gru_rel_pos_linear.weight" in sd:
            lp["gru_rel_pos_linear"] = _linear(sd, f"{attn}.gru_rel_pos_linear")
            lp["gru_rel_pos_const"] = sd[f"{attn}.gru_rel_pos_const"].reshape(-1)
        if f"{attn}.rel_attn_embed.weight" in sd:
            lp["rel_attn_embed"] = sd[f"{attn}.rel_attn_embed.weight"]
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


# ---------------------------------------------------------------------------
# export: the port's modules -> the Flax tree -> reference .pt names
# ---------------------------------------------------------------------------

def flax_path(module: nn.Module, name: str) -> Tuple[str, ...]:
    """The Flax tree path of ``module``'s parameter ``name``
    (``layers.3.q_proj.weight`` -> ``("layers_3", "q_proj", "kernel")``)."""
    parts = name.split(".")
    owner = module.get_submodule(".".join(parts[:-1])) if len(parts) > 1 else module
    path, parent = [], module
    i = 0
    while i < len(parts) - 1:
        child = getattr(parent, parts[i])
        if isinstance(child, nn.ModuleList):
            path.append(f"{parts[i]}_{parts[i + 1]}")
            parent = child[int(parts[i + 1])]
            i += 2
        else:
            path.append(parts[i])
            parent = child
            i += 1
    leaf = parts[-1]
    if leaf == "weight" and isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
        leaf = "scale"
    elif leaf == "weight" and isinstance(owner, (nn.Linear, nn.Conv1d)):
        leaf = "kernel"
    return tuple(path) + (leaf,)


def flax_tree(module: nn.Module, grads: bool = False) -> dict:
    """The inverse of ``load_flax_params``: ``module``'s parameters (or,
    with ``grads``, their ``.grad``; a parameter without one is left out)
    as a Flax params tree of NumPy arrays in the Flax names and layouts."""
    tree: dict = {}
    for full, p in module.named_parameters():
        value = p.grad if grads else p
        if value is None:
            continue
        *path, leaf = flax_path(module, full)
        arr = value.detach().float().cpu().numpy()
        if leaf == "kernel":
            arr = np.ascontiguousarray(arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0))
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def _lin_out(sd: StateDict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv_out(sd: StateDict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _norm_out(sd: StateDict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _mha_out(sd: StateDict, prefix: str, p: dict) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    sd[f"{prefix}.in_proj_weight"] = np.ascontiguousarray(np.concatenate([np.asarray(p[n]["kernel"]).T for n in names]))
    if "bias" in p["q_proj"]:
        sd[f"{prefix}.in_proj_bias"] = np.concatenate([np.asarray(p[n]["bias"]) for n in names])
    _lin_out(sd, f"{prefix}.out_proj", p["out_proj"])


def _ffn_norms_out(sd: StateDict, prefix: str, p: dict, norms) -> None:
    _lin_out(sd, f"{prefix}.linear1", p["ffn"]["linear1"])
    _lin_out(sd, f"{prefix}.linear2", p["ffn"]["linear2"])
    for n in norms:
        _norm_out(sd, f"{prefix}.{n}", p[n])


def _hf_audio_out(sd: StateDict, prefix: str, p: dict) -> None:
    fe = p["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        _conv_out(sd, f"{prefix}.feature_extractor.conv_layers.{i}.conv", fe[f"conv_{i}"])
        i += 1
    if "group_norm" in fe:
        _norm_out(sd, f"{prefix}.feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    j = 0
    while f"layer_norm_{j}" in fe:
        _norm_out(sd, f"{prefix}.feature_extractor.conv_layers.{j}.layer_norm", fe[f"layer_norm_{j}"])
        j += 1
    _norm_out(sd, f"{prefix}.feature_projection.layer_norm", p["feature_projection"]["layer_norm"])
    _lin_out(sd, f"{prefix}.feature_projection.projection", p["feature_projection"]["projection"])
    # the positional conv re-emitted as a weight-norm pair with v = w, g = |w|
    w = np.ascontiguousarray(np.asarray(p["encoder"]["pos_conv_embed"]["conv"]["kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}.encoder.pos_conv_embed.conv.weight_g"] = np.linalg.norm(w, axis=(0, 1), keepdims=True)
    sd[f"{prefix}.encoder.pos_conv_embed.conv.weight_v"] = w
    sd[f"{prefix}.encoder.pos_conv_embed.conv.bias"] = np.asarray(p["encoder"]["pos_conv_embed"]["conv"]["bias"])
    _norm_out(sd, f"{prefix}.encoder.layer_norm", p["encoder"]["layer_norm"])
    li = 0
    while f"layers_{li}" in p["encoder"]:
        lp, base = p["encoder"][f"layers_{li}"], f"{prefix}.encoder.layers.{li}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin_out(sd, f"{base}.attention.{n}", lp[n])
        _norm_out(sd, f"{base}.layer_norm", lp["layer_norm"])
        _lin_out(sd, f"{base}.feed_forward.intermediate_dense", lp["intermediate_dense"])
        _lin_out(sd, f"{base}.feed_forward.output_dense", lp["output_dense"])
        _norm_out(sd, f"{base}.final_layer_norm", lp["final_layer_norm"])
        if "gru_rel_pos_linear" in lp:
            _lin_out(sd, f"{base}.attention.gru_rel_pos_linear", lp["gru_rel_pos_linear"])
            sd[f"{base}.attention.gru_rel_pos_const"] = np.asarray(lp["gru_rel_pos_const"]).reshape(1, -1, 1, 1)
        if "rel_attn_embed" in lp:
            sd[f"{base}.attention.rel_attn_embed.weight"] = np.asarray(lp["rel_attn_embed"])
        li += 1
    if "masked_spec_embed" in p:
        sd[f"{prefix}.masked_spec_embed"] = np.asarray(p["masked_spec_embed"])


def flax_to_reference_msmd(params: dict, cfg) -> StateDict:
    """The MSMD params tree -> ``MSMD.state_dict()`` names, with the
    buffers regenerated so that torch ``load_state_dict(strict=True)``
    takes it (``msmd_tpu/interop/msmd_checkpoint.py::flax_to_reference_msmd``)."""
    from msmd_tpu_torch.ops.schedule import DiffusionSchedule
    from msmd_tpu_torch.ops.seq import alignment_mask, sinusoidal_table

    sd: StateDict = {}
    _hf_audio_out(sd, "audio_encoder", params["audio_encoder"])
    _lin_out(sd, "audio_feature_map", params["audio_feature_map"])
    for name in ("start_motion_feat", "start_audio_feat", "null_style_feat", "null_audio_feat"):
        if name in params:
            sd[name] = np.asarray(params[name])
    dn = params["denoising_net"]
    sd["denoising_net.TE.pe"] = sinusoidal_table(cfg.feature_dim, cfg.n_diff_steps + 1).numpy()[None].copy()
    _lin_out(sd, "denoising_net.diff_step_map.0", dn["diff_step_map"]["linear1"])
    _lin_out(sd, "denoising_net.diff_step_map.2", dn["diff_step_map"]["linear2"])
    if "PE" in dn:
        sd["denoising_net.PE"] = np.asarray(dn["PE"])
    _lin_out(sd, "denoising_net.person_proj", dn["person_proj"])
    _lin_out(sd, "denoising_net.feature_proj", dn["feature_proj"])
    for i in range(cfg.n_layers):
        prefix, lp = f"denoising_net.transformer.layers.{i}", dn["transformer"][f"layers_{i}"]
        _mha_out(sd, f"{prefix}.self_attn", lp["self_attn"])
        _mha_out(sd, f"{prefix}.multihead_attn", lp["cross_attn"])
        _ffn_norms_out(sd, prefix, lp, ("norm1", "norm2", "norm3"))
    if cfg.align_mask_width > 0:
        sd["denoising_net.alignment_mask"] = alignment_mask(cfg.n_prev_motions, cfg.n_motions,
                                                            cfg.align_mask_width).numpy()
    for k in range(cfg.num_of_basis):
        m = dn[f"static_feature_mapping_{k}"]
        _lin_out(sd, f"denoising_net.static_feature_mapping.{k}.0", m["linear1"])
        _lin_out(sd, f"denoising_net.static_feature_mapping.{k}.2", m["linear2"])
    _lin_out(sd, "denoising_net.motion_dec.0", dn["motion_dec_1"])
    _lin_out(sd, "denoising_net.motion_dec.2", dn["motion_dec_2"])
    sched = DiffusionSchedule.create(cfg.n_diff_steps, cfg.diff_schedule)
    for name in ("betas", "alphas", "alpha_bars", "sigmas_flex", "sigmas_inflex"):
        sd[f"diffusion_sched.{name}"] = np.asarray(getattr(sched, name))
    return sd


def flax_to_reference_style_enc(params: dict, conv_feature_dim: int = 512) -> StateDict:
    """The VAE2 params tree -> ``StyleEncoder_VAE2.state_dict()`` names
    (``msmd_checkpoint.py::flax_to_reference_style_enc``)."""
    from msmd_tpu_torch.ops.seq import sinusoidal_table

    sd: StateDict = {}
    il = params["input_layers"]
    _conv_out(sd, "input_layers.1", il["conv_0"])
    _norm_out(sd, "input_layers.5", il["norm_0"])
    _conv_out(sd, "input_layers.7", il["conv_1"])
    _norm_out(sd, "input_layers.11", il["norm_1"])
    sd["PE.pe"] = sinusoidal_table(conv_feature_dim, 600).numpy()[None].copy()
    _mha_out(sd, "encoder.self_attn", params["encoder"]["self_attn"])
    _ffn_norms_out(sd, "encoder", params["encoder"], ("norm1", "norm2"))
    _conv_out(sd, "output_layers.1", params["out_conv_0"])
    _norm_out(sd, "output_layers.5", params["out_norm"])
    _conv_out(sd, "output_layers.7", params["out_conv_1"])
    return sd
