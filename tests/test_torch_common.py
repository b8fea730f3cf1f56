"""Shared set-up for the PyTorch port's parity tests, and the port's
package-level checks: it imports with JAX blocked, imports nothing of
the JAX package, and never falls back to the CPU when CUDA was asked for.

The parity tests build the JAX model at a tiny geometry, convert its
parameters to NumPy, load them into the port with ``load_flax_params``,
and hand both packages the same NumPy inputs and noise. The geometry
makes JAX take the same per-entry decoder-kernel mode as the flagship:
lq = 1 + 7 + 8 = 16, and batch 4 with two CFG entries gives Be = 8 > 4
with a tile of 8.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

TINY_AUDIO = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                  conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4))


def tiny_cfg_kwargs(**kw):
    base = dict(feature_dim=32, n_heads=4, n_layers=2, mlp_ratio=2, d_style=16, num_of_basis=2,
                n_motions=8, n_prev_motions=7, n_diff_steps=4, use_indicator=True)
    base.update(kw)
    return base


def np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def build_msmd_pair(dtype="float32", seed=0, batch=4, **cfg_kw):
    """(jax_model, jax_variables, torch_model, cfg_kwargs) with the same
    weights; both built at ``dtype`` (parameters stay f32)."""
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.models.audio import AudioEncoderConfig as JAudio
    from msmd_tpu.models.diffusion import get_diffusion_model as jget

    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
    from msmd_tpu_torch.interop import load_flax_params
    from msmd_tpu_torch.models.diffusion import get_diffusion_model

    kw = tiny_cfg_kwargs(**cfg_kw)
    jcfg = JCfg(**kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmodel = jget(jcfg, audio_config=JAudio(**TINY_AUDIO), dtype=jdt)
    B = batch
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(seed), "diffusion": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((B, jcfg.n_motions, 67)), jnp.zeros((B, jcfg.n_audio_samples)),
        jnp.zeros((B, 100)), jnp.zeros((B, jcfg.d_style)), deterministic=True,
    )
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tmodel = get_diffusion_model(MSMDConfig(**kw), audio_config=AudioEncoderConfig(**TINY_AUDIO),
                                 dtype=tdt, device="cpu")
    load_flax_params(tmodel, np_params(variables))
    return jmodel, variables, tmodel, kw


def test_import_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil; sys.modules['jax'] = None; sys.modules['msmd_tpu'] = None\n"
        "import msmd_tpu_torch\n"
        "for m in pkgutil.walk_packages(msmd_tpu_torch.__path__, 'msmd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_import_of_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|msmd_tpu(?!_torch))\b", re.M)
    sources = list((REPO / "msmd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pat.search(p.read_text())]
    assert not offenders, offenders


def test_cuda_request_without_cuda_raises(monkeypatch):
    from msmd_tpu_torch.models.diffusion import get_diffusion_model, sample
    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
    from msmd_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    kw = tiny_cfg_kwargs()
    model = get_diffusion_model(MSMDConfig(**kw), audio_config=AudioEncoderConfig(**TINY_AUDIO),
                                device="cpu", seed=0)
    feat = torch.zeros(2, kw["n_motions"], kw["feature_dim"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample(model, feat, torch.zeros(2, 100), torch.zeros(2, kw["d_style"]), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_diffusion_model(MSMDConfig(**kw), audio_config=AudioEncoderConfig(**TINY_AUDIO))


def test_kernel_wrappers_refuse_non_cpu_tensors():
    """A wrapper takes its plain version only for CPU tensors; any other
    device launches the kernel or raises (here: the meta device)."""
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels.decoder import fused_decoder_forward
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame, skin_cuda

    x = torch.empty(2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decoder_forward({}, None, None, x, None, 1, None)
    fused = FusedFlame(synthetic_flame(n_verts=50, device="cpu"))
    with pytest.raises(ValueError, match="must be on"):
        skin_cuda(fused, torch.zeros(2, fused.n_basis), torch.zeros(2, 60))
