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


def build_decoder_pair(dtype="float32", Be=8, lq=16, F=64, H=4, L=2, FFN=128, seed=0):
    """A JAX ``TransformerDecoder`` and the port's with the same weights,
    both computing in ``dtype``, with seeded inputs x (Be, lq, F) and an
    audio memory (Be, lq - 1, F), and each side's memory K/V cache.
    Returns (jdec, jvars, tdec, x, jkv, tkv)."""
    from msmd_tpu.models import transformer as jtr
    from msmd_tpu_torch.interop import load_flax_params
    from msmd_tpu_torch.models import transformer as ttr

    rs = np.random.RandomState(seed)
    x = rs.randn(Be, lq, F).astype(np.float32)
    mem = rs.randn(Be, lq - 1, F).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdec = jtr.TransformerDecoder(L, F, H, FFN, dtype=jdt)
    v = jdec.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mem))
    tdec = load_flax_params(ttr.TransformerDecoder(L, F, H, FFN, tdt), np_params(v))
    jkv = jdec.apply(v, jnp.asarray(mem), method=jtr.TransformerDecoder.cache_memory)
    with torch.no_grad():
        tkv = tdec.cache_memory(torch.as_tensor(mem))
    return jdec, v, tdec, x, jkv, tkv


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def counting_spy(monkeypatch, module, name, counts, key=None):
    """Replace ``module.name`` by a wrapper that counts its calls in
    ``counts[key or name]``."""
    real = getattr(module, name)
    key = key or name
    counts.setdefault(key, 0)

    def counted(*a, **k):
        counts[key] += 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)


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
    from msmd_tpu_torch.models.diffusion import get_diffusion_model, sample, sample_separate, sample_with_guide
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
    for fn, extra in ((sample_with_guide, dict(guidance_indice=[0], guidance_values=np.zeros((1, 67), np.float32))),
                      (sample_separate, {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(model, feat, torch.zeros(2, 100), style_feat=torch.zeros(2, kw["d_style"]), **extra)


def test_kernel_wrappers_refuse_non_cpu_tensors():
    """A wrapper takes its plain version only for CPU tensors; any other
    device launches the kernel or raises (here: the meta device)."""
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels.decoder import fused_decoder_forward
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame, skin_cuda
    from msmd_tpu_torch.ops.kernels.sampler import fused_sampler_scan, fused_sampler_step
    from msmd_tpu_torch.ops.kernels.attn import attention_middle
    from msmd_tpu_torch.ops.kernels.ffn import fused_ffn_ln
    from msmd_tpu_torch.ops.kernels.layer_tail import fused_layer_tail

    from msmd_tpu_torch.ops.kernels.decoder import fused_decoder_forward_flat
    from msmd_tpu_torch.ops.kernels.decoder_resident import fused_decoder_forward_resident
    from msmd_tpu_torch.ops.kernels.gemm import gemm

    x = torch.empty(2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decoder_forward({}, None, None, x, None, 1, None)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decoder_forward_flat({}, None, None, x, None, 1, None, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decoder_forward_resident({}, None, None, x, None, 1, None)
    for fn in (fused_sampler_scan, fused_sampler_step):
        with pytest.raises(ValueError, match="unsupported device"):
            fn({}, None, None, torch.empty(8, 67, device="meta"), None, None, None, {}, 1, 2, 8, 67, 2, True,
               False, (1.0, 1.0))
    fused = FusedFlame(synthetic_flame(n_verts=50, device="cpu"))
    with pytest.raises(ValueError, match="must be on"):
        skin_cuda(fused, torch.zeros(2, fused.n_basis), torch.zeros(2, 60))
    w = torch.empty(128, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ffn_ln(x, w, None, w.t(), None, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        attention_middle(x, x, x, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_layer_tail(x, x, x, *([None] * 10))
    with pytest.raises(ValueError, match="unsupported device"):
        gemm(w, w.t(), None, "bf16")


TRAINING_MODULES = ("losses", "train/loop.py", "train/scheduler.py", "train/checkpoint.py", "train/trainer.py",
                    "utils/logging.py", "data/synthetic.py", "data/pickle_dataset.py", "training_script.py",
                    "ops/kernels/ffn_train.py")
GUIDED_MODULES = ("ops/kernels/ffn.py", "ops/kernels/attn.py", "ops/kernels/layer_tail.py")
DECODER_MODULES = ("ops/kernels/gemm.py",)


@pytest.mark.parametrize("module", TRAINING_MODULES + GUIDED_MODULES + DECODER_MODULES)
def test_training_modules_import_nothing_of_jax(module):
    """The training and guided-sampling slices' modules (also under the
    package-wide scan above) import neither JAX nor the JAX package."""
    path = REPO / "msmd_tpu_torch" / (module if module.endswith(".py") else module + ".py")
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|orbax|msmd_tpu(?!_torch))\b", re.M)
    assert path.exists() and not pat.search(path.read_text())


def test_training_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
    from msmd_tpu_torch.train.trainer import Trainer
    from msmd_tpu_torch.training_script import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(MSMDConfig(**tiny_cfg_kwargs()), tmp_path / "exp", audio_config=AudioEncoderConfig(**TINY_AUDIO))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--exp_name", "x", "--data_root", str(tmp_path), "--exp_root", str(tmp_path / "exps")])


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__ba0e7ed7_6_lbs_cu_28ec209010lbs_kernelENS_7LbsMapsENS_7LbsArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__ba0e7ed7_6_lbs_cu_28ec209010lbs_kernelENS_7LbsMapsENS_7LbsArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Function properties for _Z10phase_stepv
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '_Z16lbs_split_kernelPKfPfiii' for 'sm_90a'
ptxas info    : Function properties for _Z16lbs_split_kernelPKfPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 384 bytes cmem[0]
"""


def test_ptxas_entries_reads_each_function_of_a_log():
    """``_build.ptxas_entries``, the one parser of ``-Xptxas -v`` logs that
    ``chip_smoke.py`` and ``profile.py`` read registers and spills from."""
    from msmd_tpu_torch._build import ptxas_entries

    got = ptxas_entries(PTXAS_LOG)
    assert got == {
        "_ZN38_GLOBAL__N__ba0e7ed7_6_lbs_cu_28ec209010lbs_kernelENS_7LbsMapsENS_7LbsArgsE":
            dict(stack_frame=0, spill_stores=0, spill_loads=0, registers=254),
        "_Z10phase_stepv": dict(stack_frame=16, spill_stores=8, spill_loads=12),
        "_Z16lbs_split_kernelPKfPfiii": dict(stack_frame=0, spill_stores=0, spill_loads=0, registers=18),
    }
    assert ptxas_entries("") == {}
