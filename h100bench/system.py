"""The system under test, built from a configuration file and a seed:
seeded weights made on the card, loaded by name into the port's modules
(``msmd_tpu_torch``), and the same tensors kept for the reference.

Weights are drawn in one ``torch.randn`` call on the card per module
and cut into leaves: kernels N(0, 1 / fan_in), biases N(0, 0.1^2),
normalisation scales 1 + N(0, 0.1^2), free parameters (positional table,
start and null embeddings) N(0, 1). FLAME's buffers are drawn on the
card in its shapes (5023 vertices, 100 + 50 blend shapes, 5 joints).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    words = [int(t) % (1 << 64) for t in (seed, *tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(dev, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(sub_seed(seed, *tags))


def seeded_weights(shapes: Dict[str, torch.Size], dev, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """One f32 leaf a name, cut from a single draw on the card."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if name.endswith("bias"):
            t = t * 0.1
        elif name.endswith("weight") and len(shape) == 1:
            t = 1.0 + 0.1 * t
        elif name.endswith("weight"):
            t = t / math.sqrt(math.prod(shape[1:]))
        out[name] = t.contiguous()
    return out


def flame_buffers(dev, gen: torch.Generator, fl: dict) -> dict:
    """FLAME-shaped buffers: template, blend shapes, pose correctives,
    the joint regressor and the skinning weights (rows summing to 1)."""
    V, S, J = fl["n_verts"], fl["n_shape"] + fl["n_exp"], fl["n_joints"]
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    ru = lambda *s: torch.rand(*s, generator=gen, device=dev)
    J_reg, wts = ru(J, V), ru(V, J)
    return dict(v_template=rn(V, 3) * 0.1, shapedirs=rn(V, 3, S) * 0.01, posedirs=rn((J - 1) * 9, V * 3) * 0.001,
                J_regressor=J_reg / J_reg.sum(1, keepdim=True), lbs_weights=wts / wts.sum(1, keepdim=True),
                parents=np.asarray(fl["parents"], np.int64))


@dataclass
class System:
    """The port's objects and the tensors they were made from."""

    cfg: dict
    model: object  # msmd_tpu_torch MSMD, bf16 compute over f32 parameters
    style_enc: object  # VAE2, f32
    fused_flame: object  # msmd_tpu_torch FusedFlame (K5's buffers)
    weights: Dict[str, torch.Tensor]
    style_weights: Dict[str, torch.Tensor]
    flame: dict


def port_configs(cfg: dict):
    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig

    audio = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["audio"].items()}
    return MSMDConfig(**cfg["model"]), AudioEncoderConfig(**audio)


def build(cfg: dict, seed: int, dev) -> System:
    """The system of configuration ``cfg`` with weights from ``seed``."""
    from msmd_tpu_torch.models.diffusion import MSMD
    from msmd_tpu_torch.models.flame import FlameModel
    from msmd_tpu_torch.models.style_encoder import get_style_encoder
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame

    mcfg, acfg = port_configs(cfg)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    with torch.device(dev):
        model = MSMD(mcfg, audio_config=acfg, dtype=dtypes[cfg["compute_dtype"]])
        style_enc = get_style_encoder(mcfg, cfg["style_encoder"], dtype=dtypes[cfg["style_dtype"]],
                                      input_dim=mcfg.motion_feat_dim)
    weights = seeded_weights({k: v.shape for k, v in model.state_dict().items()}, dev, generator(dev, seed, 1))
    style_weights = seeded_weights({k: v.shape for k, v in style_enc.state_dict().items()}, dev,
                                   generator(dev, seed, 2))
    model.load_state_dict(weights)
    style_enc.load_state_dict(style_weights)
    model.eval()
    style_enc.eval()
    fl = flame_buffers(dev, generator(dev, seed, 3), cfg["flame"])
    V = cfg["flame"]["n_verts"]
    faces = np.stack([np.arange(V - 2), np.arange(1, V - 1), np.arange(2, V)], axis=1)
    fused = FusedFlame(FlameModel(fl["v_template"], fl["shapedirs"], fl["posedirs"], fl["J_regressor"],
                                  fl["lbs_weights"], fl["parents"], faces))
    return System(cfg, model, style_enc, fused, weights, style_weights, fl)


def decode_vertices(system: System, motion: torch.Tensor) -> torch.Tensor:
    """Frames of motion (N, 67) through the port's FLAME decode (K5):
    the first 50 expression channels, the head rotation as the global
    rotation, zero shape and jaw. Returns (N, V, 3)."""
    from msmd_tpu_torch.ops.kernels.lbs import flame_vertices

    m = motion.float()
    pose6 = torch.cat([m[:, -3:], torch.zeros_like(m[:, :3])], dim=-1)
    return flame_vertices(system.fused_flame, torch.zeros(m.shape[0], 100, device=m.device), m[:, :50], pose6)
