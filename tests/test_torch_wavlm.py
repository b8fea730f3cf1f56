"""WavLM as the port's speech encoder, on the CPU at a small size (hidden
64, 3 layers, 4 heads of 16, 32 buckets up to 64 apart, 4 s of audio):

- the bucket of every offset up to +-1100 against HF's
  ``WavLMAttention._relative_positions_bucket`` (and the benchmark's
  reference's own);
- K10's plain twin and its autograd Function (``RelposAttention``: the
  plain forward and the explicit backward formulas, dg and dr included)
  against a bias materialised by loops;
- the port's encoder, ``extract_audio_feature`` (eval, and training with
  the same dropout and SpecAugment draws), one two-clip train step's
  gradient of every encoder leaf (E, W_g, b_g and c included),
  ``infer_coeffs`` and ``StreamingBatcher`` against the plain reference
  (``h100bench/reference/wavlm.py``); HF's ``WavLMModel`` through the
  loader;
- the table built once an encoder call, the args.json round trip, the
  default config still HuBERT-base, the freezing policy, the CLI;
- ``h100bench/wavlm_work.py``'s products against ``FlopCounterMode``.

Tolerances: 1e-5 of max |reference| where one f32 computation meets
another in another summation order (the port's f32 model on the CPU
against the reference's f32: measured 1e-7 to 1e-6); 1e-4 for gradients
after a whole train step (longer chains of f32 sums, as the benchmark's
own train-step test holds them). Dropping the gate, the bias or the
shared table moves the outputs by far more than these (the bias alone
is of the size of the scores).
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import harness, wavlm_work  # noqa: E402
from h100bench import system as sysm  # noqa: E402
from h100bench.reference import model as refm  # noqa: E402
from h100bench.reference import wavlm as refw  # noqa: E402
from h100bench.reference.precision import Prec  # noqa: E402
from msmd_tpu_torch.config import (WAVLM_LARGE, AudioEncoderConfig, MSMDConfig, audio_config_from_dict,  # noqa: E402
                                   audio_config_to_dict, default_audio_config)
from msmd_tpu_torch.models.audio import AudioEncoder, audio_param_trainable, relative_bucket  # noqa: E402
from msmd_tpu_torch.ops.kernels import relpos_attn as ra  # noqa: E402
from msmd_tpu_torch.utils.profiling import counters  # noqa: E402

F32 = Prec("f32")
TOL = 1e-5
GRAD_TOL = 1e-4
DEV = torch.device("cpu")
SMALL_AUDIO = dict(hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128, conv_dim=[32] * 7,
                   num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=64)


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def small_config(n_motions: int = 100) -> dict:
    """The WavLM-Large cell's configuration file at the small size, f32."""
    cfg = json.loads((ROOT / "h100bench" / "configs" / "msmd-wavlm-large.json").read_text())
    cfg["model"].update(feature_dim=64, n_heads=1, n_layers=1, mlp_ratio=2, n_motions=n_motions, n_prev_motions=4,
                        n_diff_steps=3, d_style=16)
    cfg["audio"].update(SMALL_AUDIO)
    cfg["flame"]["n_verts"] = 64
    cfg["compute_dtype"] = cfg["style_dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def system():
    return sysm.build(small_config(), 2 ** 33 + 77, DEV)


def test_wavlm_large_is_the_published_layout():
    c = WAVLM_LARGE
    assert (c.hidden_size, c.num_layers, c.num_heads, c.intermediate_size) == (1024, 24, 16, 4096)
    assert (c.feat_extract_norm, c.conv_bias, c.do_stable_layer_norm) == ("layer", False, True)
    assert (c.num_buckets, c.max_bucket_distance, c.layer_norm_eps) == (320, 800, 1e-5)
    assert default_audio_config("wavlm") == c and default_audio_config("hubert") == AudioEncoderConfig()
    n = sum(p.numel() for p in AudioEncoder(c).parameters())
    assert 310e6 < n < 320e6, n  # about 316M with the SpecAugment embedding
    cfg = json.loads((ROOT / "h100bench" / "configs" / "msmd-wavlm-large.json").read_text())
    assert audio_config_from_dict(cfg["audio"]) == c


@pytest.mark.parametrize("buckets,distance", [(320, 800), (32, 64)])
def test_buckets_match_hf(buckets, distance):
    from transformers.models.wavlm.modeling_wavlm import WavLMAttention

    hf = WavLMAttention(64, 4, num_buckets=buckets, max_distance=distance, has_relative_position_bias=False)
    off = torch.arange(-1100, 1101)
    want = hf._relative_positions_bucket(off)
    assert torch.equal(relative_bucket(off, buckets, distance), want)
    assert torch.equal(refw.bucket(off, buckets, distance), want)


def _materialised(q, k, v, g, r):
    """softmax(q k^T / sqrt(D) + g R) v with R built by loops."""
    B, L, H, D = q.shape
    R = torch.empty(H, L, L, dtype=r.dtype)
    for h in range(H):
        for i in range(L):
            for j in range(L):
                R[h, i, j] = r[h, j - i + L - 1]
    s = torch.einsum("bihd,bjhd->bhij", q, k) / D ** 0.5 + g[..., None] * R
    return torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("L", [1, 7, 65, 130])
def test_k10_twin_and_its_backward_match_a_materialised_bias(L):
    gen = torch.Generator().manual_seed(L)
    B, H, D = 2, 3, 16
    q, k, v = (torch.randn(B, L, H, D, generator=gen, dtype=torch.float64).requires_grad_() for _ in range(3))
    g = (1 + torch.rand(B, H, L, generator=gen, dtype=torch.float64)).requires_grad_()
    r = torch.randn(H, 2 * L - 1, generator=gen, dtype=torch.float64).requires_grad_()
    w = torch.randn(B, L, H, D, generator=gen, dtype=torch.float64)
    leaves = (q, k, v, g, r)
    want = _materialised(*leaves)
    want_grads = torch.autograd.grad((want * w).sum(), leaves)
    # the plain versions compute in f32
    assert rel(ra.relpos_attention_plain(*leaves), want) < 1e-6
    got = ra.relpos_attention(*leaves)
    assert rel(got, want) < 1e-6
    for a, b in zip(torch.autograd.grad((got * w).sum(), leaves), want_grads):
        # the explicit backward runs in f32: 1e-5 of the gradient's size, or of 1 where it is nought (L = 1: dq, dk)
        assert float((a - b).abs().max()) < 1e-5 * max(float(b.abs().max()), 1.0)
    out, lse = ra.relpos_attention_fwd_plain(*leaves)
    assert rel(lse, torch.logsumexp(torch.einsum("bihd,bjhd->bhij", q, k) / D ** 0.5
                                    + ra.bias_plain(g, r), dim=-1)) < 1e-6


def test_k10_gate_and_wrapper_refusals():
    assert ra.relpos_kernel_takes(32, 200, 16, 64, torch.bfloat16)
    assert ra.relpos_kernel_takes(1, 1024, 16, 64, torch.bfloat16)
    assert not ra.relpos_kernel_takes(1, ra.MAX_L + 1, 16, 64, torch.bfloat16)
    assert not ra.relpos_kernel_takes(1, 200, 16, 32, torch.bfloat16)
    assert not ra.relpos_kernel_takes(1, 200, 16, 64, torch.float32)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    g, r = torch.zeros(1, 2, 8), torch.zeros(2, 15)
    with pytest.raises(ValueError, match="runs on the card"):
        ra.relpos_attention_cuda(q, q, q, g, r)


def test_encoder_matches_the_reference(system):
    s = system
    c = s.model.audio_encoder.config
    assert c.relative_position and c.do_stable_layer_norm and c.feat_extract_norm == "layer"
    audio = refm.pad_audio(torch.randn(2, 64000, generator=torch.Generator().manual_seed(3)))
    with torch.no_grad():
        got = s.model.audio_encoder(audio, 25, 200)
        want = refw.wavlm(s.weights, audio, 200, 25, s.cfg["audio"], F32)
    assert got.shape == want.shape == (2, 200, 64)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("train", [False, True])
def test_extract_audio_feature_matches_the_reference(system, train):
    s = system
    audio = torch.randn(3, 64000, generator=torch.Generator().manual_seed(4))
    seed = 2 ** 40 + 3
    with torch.no_grad():
        if train:
            got = s.model.extract_audio_feature(audio, rng=torch.Generator().manual_seed(seed))
            want = refw.audio_train(s.weights, audio, 100, 25, s.cfg["audio"], torch.Generator().manual_seed(seed),
                                    F32)
        else:
            got = s.model.extract_audio_feature(audio)
            want = refw.audio_features(s.weights, audio, 100, 25, s.cfg["audio"], F32)
    assert got.shape == want.shape == (3, 100, 64)
    assert rel(got, want) < TOL


def test_one_table_an_encoder_call(system):
    s = system
    audio = torch.randn(2, 64000, generator=torch.Generator().manual_seed(5))
    before = counters()
    with torch.no_grad():
        s.model.extract_audio_feature(audio)
        s.model.extract_audio_feature(audio[:1])
    after = counters()
    assert after.get("msmd.wavlm.bias_tables", 0) - before.get("msmd.wavlm.bias_tables", 0) == 2


def _train_cell(cfg=None):
    real = harness.Cell.load("msmd-wavlm-large.train16")
    traffic = dict(mode="train_wavlm", batch=2, check_steps=1, warmup_steps=0, trace_units=1)
    return harness.Cell("small.train_wavlm", 1, cfg or small_config(), traffic, real.limits, real.end_to_end,
                        real.per_layer)


@pytest.mark.parametrize("seed", [6, 2 ** 33 + 5])
def test_train_step_gradients_of_every_encoder_leaf_match_the_reference(seed):
    """One two-clip vertex-space step of the port (f32) against the
    reference replaying its draws: the gradient of every trained leaf of
    the audio encoder, tensor by tensor, and the benchmark's own check."""
    cell = _train_cell()
    mode = harness.mode_of(cell)
    ctx = harness.Context(cell, seed, 0.0, False, DEV)
    mode.setup(ctx)
    sy, cfg = ctx.system, cell.config
    got = ctx.state["grad1"]
    names = {**{"m." + k: v for k, v in sy.weights.items()}, **{"s." + k: v for k, v in sy.style_weights.items()}}
    train = [k for k in names if k.startswith("s.") or mode.trainable(k[2:])]
    g, hg = mode._train.generators(ctx)
    batches = [mode._train.batch(ctx, 0)]
    _, want, _ = mode._reft.train_steps(sy.weights, sy.style_weights, train, sy.flame, mode._train.coef_stats(ctx),
                                        cfg["model"], cfg["audio"], batches, g, hg, F32, F32, 2e-5)
    audio = [k for k in want if k.startswith("m.audio_encoder.")]
    for leaf in ("encoder.layers.0.rel_attn_embed", "encoder.layers.2.gru_rel_pos_linear.weight",
                 "encoder.layers.1.gru_rel_pos_linear.bias", "encoder.layers.1.gru_rel_pos_const",
                 "encoder.layer_norm.weight", "feature_projection.projection.weight", "masked_spec_embed"):
        assert "m.audio_encoder." + leaf in audio, leaf
    assert not any(k.startswith("m.audio_encoder.feature_extractor.") for k in audio)
    # a leaf's error over the larger of its own largest gradient and the median leaf's: the key projection's
    # bias has no gradient (a row's softmax ignores a constant), so both sides hold round-off there
    size = {k: float(want[k].abs().max()) for k in audio}
    median = sorted(size.values())[len(size) // 2]
    for k in audio:
        assert float((got[k] - want[k]).abs().max()) < GRAD_TOL * max(size[k], median), k
    run = mode.window(ctx, None)
    checks = mode.check(ctx, run)
    assert checks["grad_gap"] < GRAD_TOL and checks["update_gap"] < GRAD_TOL, checks


def test_infer_coeffs_and_the_batcher_match_the_reference():
    """A padded clip of two windows through ``infer_coeffs`` and two
    streams through ``StreamingBatcher`` with a WavLM model, against the
    reference's inference with WavLM's features (a private copy of
    ``reference/model.py`` whose ``audio_features`` is WavLM's)."""
    from h100bench.modes.stream import batcher_draw
    from msmd_tpu_torch.inference_lib import infer_coeffs
    from msmd_tpu_torch.serving import StreamingBatcher

    s = sysm.build(small_config(n_motions=8), 2 ** 35 + 1, DEV)
    ref = harness.load_file_module(ROOT / "h100bench" / "reference" / "model.py")
    ref.audio_features = refw.audio_features
    m = s.cfg["model"]
    L, T, ns = m["n_motions"], m["n_diff_steps"], round(640 * m["n_motions"])
    g = torch.Generator().manual_seed(8)
    audio = torch.randn(int(0.5 * 16000), generator=g)
    style = torch.randn(1, m["d_style"], generator=g)
    x_T, z = torch.randn(2, L, 67, generator=g), torch.randn(T, 2, L, 67, generator=g)
    with torch.no_grad():
        got = infer_coeffs(s.model, audio, torch.zeros(1, 100), style_feats=style, n_repetitions=2, cfg_scale=1.15,
                           dynamic_threshold=None, motion_at_T=x_T, noise_override=z, device="cpu")
        want = ref.infer_clip(s.weights, m, audio, torch.zeros(2, 100), style.expand(2, -1), x_T, z, 1.15, None,
                              F32, s.cfg["audio"])
    assert got.shape == want.shape
    assert rel(got, want) < 1e-4
    streams = torch.randn(2, 2 * ns, generator=g)
    styles = torch.randn(2, m["d_style"], generator=g)
    seeds = [3, 2 ** 31 - 7]
    bat = StreamingBatcher(s.model, max_slots=2, cfg_scale=1.15, pipeline_depth=2, device="cpu")
    for j in range(2):
        bat.add_stream(f"s{j}", seed=seeds[j], style=styles[j].numpy())
        bat.push_audio(f"s{j}", streams[j].numpy(), final=True)
    with torch.no_grad():
        bat.run_until_drained()
        got = torch.stack([torch.as_tensor(bat.output(f"s{j}")) for j in range(2)])
        x_T = torch.stack([batcher_draw(DEV, sd, 0, 0, (L, 67)) for sd in seeds])
        noises = [torch.stack([batcher_draw(DEV, sd, w, 1, (T, L, 67)) for sd in seeds], dim=1) for w in range(2)]
        want = ref.stream_clip(s.weights, m, streams, torch.zeros(2, 100), styles, x_T, noises, F32,
                               s.cfg["audio"], 1.15)
    assert rel(got, want) < 1e-4


def _hf_small(conv_bias: bool = True):
    from transformers import WavLMConfig, WavLMModel

    torch.manual_seed(0)
    hf = WavLMModel(WavLMConfig(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128, conv_dim=[32, 32, 32],
        conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2], num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=32, max_bucket_distance=64, do_stable_layer_norm=True, feat_extract_norm="layer",
        conv_bias=conv_bias, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0)).eval()
    with torch.no_grad():  # away from HF's init (ones, zeros) so that every leaf shows
        for n, p in hf.named_parameters():
            if "gru_rel_pos_const" in n or "layer_norm" in n or n.endswith("bias"):
                p.add_(torch.randn_like(p) * 0.3)
    return hf


class _Holder(nn.Module):
    def __init__(self, c: AudioEncoderConfig):
        super().__init__()
        self.audio_encoder = AudioEncoder(c)


SMALL_HF = dict(hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128, conv_dim=(32, 32, 32),
                conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, feat_extract_norm="layer", do_stable_layer_norm=True,
                num_buckets=32, max_bucket_distance=64)


@pytest.mark.parametrize("prefix", ["", "wavlm."])
def test_hf_wavlm_loads_through_the_loader(tmp_path, prefix):
    from msmd_tpu_torch.hf_loader import inject_pretrained_audio, write_safetensors

    hf = _hf_small()
    write_safetensors(tmp_path / "model.safetensors", {prefix + k: v for k, v in hf.state_dict().items()})
    m = _Holder(AudioEncoderConfig(**SMALL_HF, conv_bias=True)).eval()
    inject_pretrained_audio(m, str(tmp_path))
    x = torch.randn(2, 6400, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = hf(x).last_hidden_state
        got = m.audio_encoder(x)
    assert rel(got, want) < TOL
    E = hf.encoder.layers[0].attention.rel_attn_embed.weight
    assert torch.equal(m.audio_encoder.encoder.layers[0].rel_attn_embed.detach(), E.detach())


def test_a_layer_mode_file_into_the_base_layout_raises_and_loads_nothing(tmp_path):
    from msmd_tpu_torch.hf_loader import inject_pretrained_audio, write_safetensors

    write_safetensors(tmp_path / "model.safetensors", _hf_small(conv_bias=False).state_dict())
    base = dict(SMALL_HF, feat_extract_norm="group", do_stable_layer_norm=False, num_buckets=0)
    m = _Holder(AudioEncoderConfig(**base))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pytest.raises(ValueError, match="layout"):
        inject_pretrained_audio(m, str(tmp_path))
    assert all(torch.equal(before[k], v) for k, v in m.state_dict().items())


def test_the_default_config_is_hubert_base_as_before():
    """The default builds the base layout: the parameter names and shapes
    of HF's HubertModel at hubert-base-ls960's widths, through the name
    mapping, and none of WavLM's."""
    from transformers import HubertConfig, HubertModel

    from msmd_tpu_torch.interop import _hf_audio_encoder, flax_tree

    enc = AudioEncoder(AudioEncoderConfig())
    hf = HubertModel(HubertConfig())
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    flat = lambda t, p="": {k2: v2 for k, v in t.items() for k2, v2 in
                            (flat(v, f"{p}{k}/").items() if isinstance(v, dict) else [(p + k, v.shape)])}
    want = flat(_hf_audio_encoder(sd))
    got = flat(flax_tree(enc))
    assert set(got) - {"masked_spec_embed"} == set(want) - {"masked_spec_embed"}
    assert all(tuple(got[k]) == tuple(want[k]) for k in want if k in got)
    names = [n for n, _ in enc.named_parameters()]
    assert "feature_extractor.group_norm.weight" in names
    assert not any("rel_attn" in n or "gru_rel" in n or "feature_extractor.layer_norm" in n for n in names)
    assert not any(n.startswith("feature_extractor.conv.") and n.endswith("bias") for n in names)


def test_a_wavlm_audio_config_round_trips_args_json(tmp_path):
    cfg = MSMDConfig(audio_model="wavlm", audio_encoder_config=audio_config_to_dict(WAVLM_LARGE))
    cfg.save_args_json(tmp_path)
    back = MSMDConfig.load_args_json(tmp_path)
    assert back.audio_model == "wavlm"
    assert audio_config_from_dict(back.audio_encoder_config) == WAVLM_LARGE
    base = audio_config_to_dict(AudioEncoderConfig(hidden_size=32))
    assert "num_buckets" not in base and "feat_extract_norm" not in base  # what the JAX package reads
    assert audio_config_from_dict(base) == AudioEncoderConfig(hidden_size=32)


def test_wavlm_trains_everything_but_the_conv_front():
    enc = AudioEncoder(AudioEncoderConfig(**SMALL_HF))
    for name, _ in enc.named_parameters():
        assert audio_param_trainable("wavlm", name) == (not name.startswith("feature_extractor.")), name
    assert not audio_param_trainable("hubert", "encoder.layers.1.q_proj.weight")


def test_the_cli_trains_wavlm_and_the_checkpoint_loads(tmp_path):
    from msmd_tpu_torch import training_script
    from msmd_tpu_torch.data.synthetic import write_synthetic_dataset
    from msmd_tpu_torch.inference_lib import load_model

    write_synthetic_dataset(tmp_path / "data", name="tinyset", n_videos=8, seed=0)
    training_script.main([
        "--mode", "train", "--exp_name", "wl", "--data_root", str(tmp_path / "data"), "--dataset_type", "tinyset",
        "--batch_size", "2", "--max_iter", "1", "--save_iter", "1", "--val_iter", "0", "--log_iter", "1",
        "--feature_dim", "16", "--n_heads", "2", "--n_layers", "1", "--mlp_ratio", "2", "--d_style", "16",
        "--n_motions", "8", "--n_prev_motions", "4", "--n_diff_steps", "2", "--num_of_basis", "2",
        "--use_indicator", "--use_cross_style", "--tiny_audio_encoder", "--audio_model", "wavlm",
        "--compute_dtype", "float32", "--exp_root", str(tmp_path / "exp"), "--lr", "1e-4", "--warm_iter", "1",
        "--two_clip_batch", "--device", "cpu"])
    exp = next((tmp_path / "exp").iterdir())
    args = json.loads((exp / "args.json").read_text())
    assert args["audio_model"] == "wavlm" and args["audio_encoder_config"]["num_buckets"] == 32
    it = sorted(p.name for p in (exp / "checkpoints").glob("iter_*.pt"))[-1][5:-3]
    model, _, cfg = load_model(tmp_path / "exp", exp.name, it, device="cpu")
    assert model.audio_encoder.config.relative_position
    assert model.audio_encoder.encoder.layers[0].rel_attn_embed.shape == (32, 4)


def test_the_step_count_matches_flop_counter_mode():
    """``wavlm_work.audio_feature_flops`` against ``FlopCounterMode`` over
    the reference's forward. Both count only products: the convolutions,
    the linear layers (the gate's included) and the attention's two
    einsums. What FlopCounterMode cannot see, the LayerNorms, GELU,
    softmax, the gate's sigmoids and sums, biases, the bucket gather and
    the resampling, the count leaves out too."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = small_config()
    s = sysm.build(cfg, 11, DEV)
    audio = torch.randn(2, 64000, generator=torch.Generator().manual_seed(10))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        refw.audio_features(s.weights, audio, 100, 25, cfg["audio"], F32)
    want = 2 * wavlm_work.audio_feature_flops(64000, 100, cfg["audio"], F=cfg["model"]["feature_dim"])
    assert fc.get_total_flops() == want


def test_the_k10_bound_is_linear_in_the_rows():
    one = wavlm_work.k10_bound_s(200 * 32, 200 * 32, 200)
    assert wavlm_work.k10_bound_s(200 * 96, 200 * 32, 200) > one
    f, b = wavlm_work.k10_work(32, 200)
    assert f == 2 * 2 * 32 * 16 * 200 * 200 * 64 and b == 32 * 16 * 200 * (4 * 64 * 2 + 2 * 4)
    assert wavlm_work.train_step_flops(16, copy.deepcopy(json.loads(
        (ROOT / "h100bench" / "configs" / "msmd-wavlm-large.json").read_text())["audio"])) > 1e13
    assert np.isclose(one, wavlm_work.k10_bound_s(200 * 32, 0, 200) + wavlm_work.k10_bound_s(0, 200 * 32, 200))


def test_the_wavlm_spans_nest_inside_the_audio_encoder(system):
    """Inside a profiler session one encoder call opens
    ``msmd.audio_encoder`` and in it ``.features``, then ``.rel_bias`` (the
    table), then ``.layers`` holding one ``.rel_bias`` a layer (the gates)."""
    from torch.profiler import ProfilerActivity, profile

    audio = torch.randn(1, 64000, generator=torch.Generator().manual_seed(12))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        system.model.extract_audio_feature(audio)
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name.startswith("msmd.audio_encoder")), key=lambda t: (t[0], -t[1]))
    names = [n for _, _, n in spans]
    layers = system.cfg["audio"]["num_layers"]
    assert names == (["msmd.audio_encoder", "msmd.audio_encoder.features", "msmd.audio_encoder.rel_bias",
                      "msmd.audio_encoder.layers"] + ["msmd.audio_encoder.rel_bias"] * layers)
    (a0, a1, _), (l0, l1, _) = spans[0], spans[3]
    assert all(a0 <= s0 and s1 <= a1 for s0, s1, _ in spans[1:])
    assert all(l0 <= s0 and s1 <= l1 for s0, s1, _ in spans[4:])


def test_the_wavlm_window_counts_k10_rows_over_the_kept_traced_steps():
    """``modes/train_wavlm.py``'s tracer wrapper: the change of K10's row
    counters over each traced step the tracer keeps, none over a step
    whose session it drops; every other attribute is the tracer's."""
    from h100bench.modes import train_wavlm as tw
    from msmd_tpu_torch.utils.profiling import count

    class Tracer:
        sessions = 0

        def run(self, fn):
            fn()
            self.sessions += 1
            return None, (None if self.sessions == 2 else object())

    def step():
        count("msmd.k10.fwd_rows", 6400)
        count("msmd.k10.bwd_rows", 3200)

    wrapped = tw._CountingTracer(Tracer())
    for _ in range(3):
        wrapped.run(step)
    assert wrapped.work == {"k10_fwd_rows": 2 * 6400, "k10_bwd_rows": 2 * 3200}
    assert wrapped.sessions == 3
