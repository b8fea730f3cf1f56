"""The plain reference (``h100bench/reference``) against the port at tiny
widths on the CPU, both in float32: the audio features, the style
encoder, one denoiser call, whole clips through ``infer_coeffs`` (with
and without the dynamic threshold), streams through ``StreamingBatcher``,
the FLAME decode, and three vertex-space training steps with every
random draw replayed. Float32 on both sides, so the gaps are the order
of operations: 1e-4 of the largest value, against the 1e-2 that bfloat16
products give."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import tiny_config
from h100bench import system as sysm
from h100bench.reference import model as ref
from h100bench.reference.precision import Prec

F32 = Prec("f32")
TOL = 1e-4
DEV = torch.device("cpu")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def f32_system():
    cfg = tiny_config()
    cfg["compute_dtype"] = "float32"
    return sysm.build(cfg, 987654321987, DEV)


def test_reference_imports_nothing_of_the_program_or_of_jax():
    for path in (Path(__file__).resolve().parents[1] / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in ("msmd_tpu_torch", "msmd_tpu", "jax", "jaxlib", "flax"), (path, n)


def test_audio_features_match_the_port(f32_system):
    s = f32_system
    g = torch.Generator().manual_seed(1)
    audio = torch.randn(2, 14080, generator=g)
    with torch.no_grad():
        want = ref.audio_features(s.weights, audio, 22, 25, s.cfg["audio"], F32)
        got = s.model.extract_audio_feature(audio, 22)
    assert rel(got, want) < TOL


def test_style_encoder_matches_the_port(f32_system):
    s = f32_system
    clip = torch.randn(3, 12, 67, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert rel(s.style_enc.encode_mean(clip), ref.style_mean(s.style_weights, clip, F32)) < TOL


def test_denoiser_call_matches_the_port(f32_system):
    s = f32_system
    m = s.cfg["model"]
    g = torch.Generator().manual_seed(3)
    N, L, P, Fd = 3, m["n_motions"], m["n_prev_motions"], m["feature_dim"]
    rn = lambda *shape: torch.randn(*shape, generator=g)
    args = dict(motion=rn(N, L, 67), audio_feat=rn(N, L, Fd), person=rn(N, 1, 100 + m["d_style"]),
                style=rn(N, 1, m["d_style"]), prev_motion=rn(N, P, 67), prev_audio=rn(N, P, Fd),
                indicator=(torch.arange(L) < L - 2).float().expand(N, L))
    with torch.no_grad():
        got = s.model.denoising_net(args["motion"], args["audio_feat"], args["person"], args["style"],
                                    args["prev_motion"], args["prev_audio"], torch.full((N,), 2),
                                    args["indicator"])
        want = ref.denoise(s.weights, m, args["motion"], args["audio_feat"], args["person"], args["style"],
                           args["prev_motion"], args["prev_audio"], 2, args["indicator"], F32)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("dynamic_threshold", [None, (0, 1, 4)])
@pytest.mark.parametrize("seconds", [0.3, 0.9])
def test_a_clip_through_infer_coeffs_matches_the_reference(f32_system, dynamic_threshold, seconds):
    """One window and a padded clip of three, three takes."""
    from msmd_tpu_torch.inference_lib import infer_coeffs

    s = f32_system
    m = s.cfg["model"]
    g = torch.Generator().manual_seed(4)
    R, L, T = 3, m["n_motions"], m["n_diff_steps"]
    audio = torch.randn(int(seconds * 16000), generator=g)
    style = torch.randn(1, m["d_style"], generator=g)
    x_T, z = torch.randn(R, L, 67, generator=g), torch.randn(T, R, L, 67, generator=g)
    with torch.no_grad():
        got = infer_coeffs(s.model, audio, torch.zeros(1, 100), style_feats=style, n_repetitions=R,
                           cfg_scale=1.15, dynamic_threshold=dynamic_threshold, motion_at_T=x_T, noise_override=z,
                           device="cpu")
        want = ref.infer_clip(s.weights, m, audio, torch.zeros(R, 100), style.expand(R, -1), x_T, z, 1.15,
                              dynamic_threshold, F32, s.cfg["audio"])
    assert got.shape == want.shape
    assert rel(got, want) < TOL


def test_streams_through_the_batcher_match_the_reference(f32_system):
    """Three streams of two windows over two slots (so streams wait and
    are evicted), each against the reference from the batcher's draws."""
    from msmd_tpu_torch.serving import StreamingBatcher

    from h100bench.modes.stream import batcher_draw

    s = f32_system
    m = s.cfg["model"]
    L, T, ns = m["n_motions"], m["n_diff_steps"], round(640 * m["n_motions"])
    g = torch.Generator().manual_seed(5)
    audio = torch.randn(3, 2 * ns, generator=g)
    styles = torch.randn(3, m["d_style"], generator=g)
    seeds = [11, 2 ** 31 - 5, 123456]
    bat = StreamingBatcher(s.model, max_slots=2, cfg_scale=1.15, pipeline_depth=2, device="cpu")
    for j in range(3):
        bat.add_stream(f"s{j}", seed=seeds[j], style=styles[j].numpy())
        bat.push_audio(f"s{j}", audio[j].numpy(), final=True)
    with torch.no_grad():
        bat.run_until_drained()
        got = torch.stack([torch.as_tensor(bat.output(f"s{j}")) for j in range(3)])
        x_T = torch.stack([batcher_draw(DEV, sd, 0, 0, (L, 67)) for sd in seeds])
        noises = [torch.stack([batcher_draw(DEV, sd, w, 1, (T, L, 67)) for sd in seeds], dim=1) for w in range(2)]
        want = ref.stream_clip(s.weights, m, audio, torch.zeros(3, 100), styles, x_T, noises, F32, s.cfg["audio"],
                               1.15)
    assert rel(got, want) < TOL


def test_flame_decode_matches_the_port(f32_system):
    s = f32_system
    motion = torch.randn(5, 67, generator=torch.Generator().manual_seed(6)) * 0.5
    with torch.no_grad():
        got = sysm.decode_vertices(s, motion)
        want = ref.motion_to_vertices(s.flame, motion, F32)
    assert rel(got, want) < 1e-5


def test_cfg_entries_drop_the_zero_coefficient():
    assert [e for e, _ in ref.cfg_entries(1.15)] == ["null", "both"]
    assert ref.cfg_entries(1.15)[0][1] == pytest.approx(-0.15)


def test_ddpm_coefficients_end_in_the_clean_sample():
    A, B, sig = ref.ddpm_coefficients(500)
    assert (A[1], B[1], sig[1]) == (0.0, 1.0, 0.0)
    assert np.all(sig[2:] > 0)


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    err = (Prec("fp8").q(x) - x).abs().max() / x.abs().max()
    assert 1e-3 < err < 0.07
    assert torch.equal(Prec("f32").q(x), x)


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_train_steps_match_the_reference_at_f32(seed, one_thread):
    """Three steps of the port's vertex-space two-clip training step, f32
    throughout, against the reference's replay of every draw: the first
    gradient and the weights' change after the three, leaf by leaf."""
    from conftest import cpu_run, tiny_cell

    cfg = tiny_config("msmd-hdtf-vertex")
    cfg["compute_dtype"] = cfg["style_dtype"] = "float32"
    *_, got = cpu_run("train", seed, cell=tiny_cell("train", cfg))
    assert got["grad_gap"] < 1e-4 and got["update_gap"] < 1e-4, got


def test_philox_bits_follow_the_published_generator():
    """Philox4x32-10's known-answer vector (Random123's kat_vectors): key
    (0, 0), counter 0 -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8."""
    from h100bench.reference.train import philox_words

    z = torch.zeros((), dtype=torch.int64)
    assert [int(v) for v in philox_words(z, 0, z, z, z, z)] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
