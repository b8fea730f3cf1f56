"""Pretrained wav2vec2 / HuBERT / WavLM weights from local Hugging Face files, into
the port's audio encoder (the port of ``msmd_tpu/interop/hf_loader.py``).

The reference calls ``from_pretrained('facebook/hubert-base-ls960')`` with
a cache_dir (model.py:100-104); a host without network needs the weights
on disk: a model directory (``config.json`` with ``model.safetensors`` or
``pytorch_model.bin``) or an HF cache root holding
``models--org--name/snapshots/<rev>/``. The state dict goes through the
port's copy of the name mapping (``interop._hf_audio_encoder``; the
``wav2vec2.`` / ``hubert.`` / ``wavlm.`` prefix of a task model is
stripped). A file whose layout (its conv front's norms and biases, WavLM's
gated attention) is not the encoder's is refused before anything loads.

The port reads ``.safetensors`` itself (an 8-byte little-endian header
length, a JSON header of dtype / shape / byte range per tensor, then the
raw bytes) and ``.bin`` with ``torch.load(weights_only=True)``: it needs
neither ``safetensors`` nor ``transformers``. ``write_safetensors`` is the
same format's writer.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from msmd_tpu_torch.interop import _convert, _hf_audio_encoder

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on ``device``."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = bytearray(data[8 + n:])
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']}, which the reader does not take")
        begin, end = meta["data_offsets"]
        dt = _DTYPES[meta["dtype"]]
        t = torch.frombuffer(body, dtype=dt, count=(end - begin) // dt.itemsize, offset=begin) if end > begin \
            else torch.empty(0, dtype=dt)
        out[name] = t.reshape(meta["shape"]).to(device, copy=True)
    return out


def write_safetensors(path, tensors: Mapping[str, torch.Tensor]) -> Path:
    """Write ``tensors`` (contiguous copies on the CPU) as a ``.safetensors``
    file, in the order given."""
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    path = Path(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)
    return path


def _find_weight_file(model_dir: Path) -> Path:
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = model_dir / name
        if p.exists():
            return p
    raise FileNotFoundError(f"No weight file (model.safetensors / pytorch_model.bin) under {model_dir}")


def resolve_model_dir(path_or_name: str, cache_dir: Optional[str] = None) -> Path:
    """A local directory, or the newest snapshot of an HF-hub cache layout
    (``<cache>/models--org--name/snapshots/<rev>/``)."""
    p = Path(path_or_name)
    if p.is_dir():
        return p
    if cache_dir is not None:
        snaps = Path(cache_dir) / ("models--" + path_or_name.replace("/", "--")) / "snapshots"
        if snaps.exists():
            revs = sorted(snaps.iterdir())
            if revs:
                return revs[-1]
    raise FileNotFoundError(
        f"Cannot resolve pretrained weights for {path_or_name!r}: provide a local model directory "
        f"(a host without network cannot download)."
    )


def load_state_dict_file(path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` or torch ``.bin`` file as {name: f32 or integer
    NumPy array} (bf16 and f16 widened to f32)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    wide = lambda t: t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    return {k: wide(v).numpy() for k, v in sd.items()}


def load_hf_audio_encoder_params(path_or_name: str, cache_dir: Optional[str] = None) -> dict:
    """-> the audio encoder's Flax-named tree (NumPy)."""
    sd = load_state_dict_file(_find_weight_file(resolve_model_dir(path_or_name, cache_dir)))
    for prefix in ("wav2vec2.", "hubert.", "wavlm."):  # a task model's checkpoint
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    return _hf_audio_encoder(sd)


def tree_layout(tree: Mapping) -> dict:
    """The layout fields an encoder tree implies: its conv front's norm
    ("layer" with a LayerNorm on every convolution) and biases, and
    whether its layers have WavLM's gated relative-position attention."""
    fe = tree["feature_extractor"]
    layers = [v for k, v in tree["encoder"].items() if k.startswith("layers_")]
    return {"feat_extract_norm": "layer" if "layer_norm_0" in fe else "group",
            "conv_bias": "bias" in fe["conv_0"],
            "relative_position": any("gru_rel_pos_linear" in lp for lp in layers)}


@torch.no_grad()
def inject_pretrained_audio(model: nn.Module, path_or_name: str, cache_dir: Optional[str] = None) -> nn.Module:
    """Copy pretrained weights into ``model.audio_encoder`` in place: every
    parameter the file has, shape-checked against the module's own (a
    mismatch raises with the parameter's name); the others keep their
    values, as the JAX loader keeps the init's leaves. A file of another
    layout than the encoder's config (``tree_layout``) raises; nothing is
    copied until every check has passed. Returns ``model``."""
    params = dict(model.audio_encoder.named_parameters())
    new = {}

    def walk(node: Mapping, prefix: str):
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = key.rsplit("_", 1)
                child = f"{m[0]}.{m[1]}" if len(m) == 2 and m[1].isdigit() else key
                walk(value, f"{prefix}{child}.")
            else:
                new[prefix + {"kernel": "weight", "scale": "weight"}.get(key, key)] = (key, np.asarray(value))

    tree = load_hf_audio_encoder_params(path_or_name, cache_dir)
    c = model.audio_encoder.config
    have = {"feat_extract_norm": c.feat_extract_norm, "conv_bias": c.conv_bias,
            "relative_position": c.relative_position}
    got = tree_layout(tree)
    if got != have:
        raise ValueError(f"the pretrained weights at {path_or_name} have the layout {got}, the audio encoder "
                         f"{have}: set audio_model / audio_encoder_config to the file's encoder")
    walk(tree, "")
    staged = []
    for name, (key, value) in new.items():
        p = params.get(name)
        if p is None:
            continue
        arr = _convert(key, value, p)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at audio_encoder.{name}: the model has {tuple(p.shape)}, "
                             f"the pretrained weights {tuple(arr.shape)}")
        staged.append((p, arr))
    for p, arr in staged:
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)))
    return model
