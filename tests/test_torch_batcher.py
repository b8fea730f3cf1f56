"""The port's ``StreamingBatcher`` (``msmd_tpu_torch/serving.py``).

- The eight properties that ``tests/test_serving_batcher.py`` holds the
  JAX batcher to, on the port at f32 (the plain modules): one window
  equals ``infer_coeffs`` given the batcher's documented draws; a stream's
  output does not depend on its batch mates; window 1 takes window 0's
  carry and reuses its motion_at_T, and a corrupted carry changes it; a
  final partial window is trimmed; five streams on two slots finish in
  three rounds; eviction and re-admission keep every output (against the
  stream alone in a batcher of as many slots); a carry moved to another
  batcher continues bit for bit; ``pipeline_depth`` only delays the
  fetches. Tolerances are the JAX tests' (1e-5 relative, 1e-6 absolute,
  or exact).
- A stream that holds a slot while it waits for audio keeps its carry.
- Against the JAX batcher: the port's batcher with ``_draw`` replaying
  the JAX batcher's threefry draws (computed here with ``jax.random``)
  gives the JAX batcher's outputs at f32, two streams over two rounds
  (one with a partial final window), atol 1e-5.
- The decoder route each slot count takes at bf16 (spies on the kernel
  wrappers, whose plain versions run on the CPU): 1 slot the batch-1
  kernel K3, 2 slots (Be = 4) K1's flat-mask mode, 4 slots (Be = 8) K1
  per-entry, and with ``resident=True`` K2.
"""

import numpy as np
import jax
import pytest
import torch

from msmd_tpu_torch.inference_lib import infer_coeffs
from msmd_tpu_torch.serving import StreamingBatcher, draw_seed

from test_torch_common import build_msmd_pair, counting_spy


@pytest.fixture(scope="module")
def pair():
    jm, jv, tm, kw = build_msmd_pair("float32", seed=50)
    return jm, jv, tm, tm.cfg


def _audio(cfg, n_windows, seed, extra_samples=0):
    rng = np.random.RandomState(seed)
    return rng.randn(int(cfg.n_audio_samples * n_windows + extra_samples)).astype(np.float32)


def _style(cfg, seed):
    return np.random.RandomState(100 + seed).randn(cfg.d_style).astype(np.float32)


def _batcher(model, slots, **kw):
    return StreamingBatcher(model, max_slots=slots, device="cpu", **kw)


def _alone(model, cfg, seed, style, audio, slots):
    """The stream served alone, in a batcher of ``slots`` slots (the same
    batch shape as the run it is compared with, so the same f32 sums)."""
    bat = _batcher(model, slots)
    bat.add_stream("s", seed, style=style)
    bat.push_audio("s", audio, final=True)
    bat.run_until_drained()
    return bat.output("s")


def test_draw_seeds_are_distinct():
    seeds = {draw_seed(s, w, j) for s in (0, 1, 2 ** 31 - 1) for w in (0, 1, 2 ** 31 - 1) for j in (0, 1)}
    assert len(seeds) == 18
    with pytest.raises(ValueError):
        draw_seed(2 ** 31, 0, 0)


def test_single_window_matches_infer_coeffs(pair):
    _, _, model, cfg = pair
    bat = _batcher(model, 2)
    audio, style = _audio(cfg, 1, seed=5), _style(cfg, 0)
    bat.add_stream("a", 42, style=style)
    bat.push_audio("a", audio, final=True)
    assert bat.step() == 1 and bat.finished("a")
    out = bat.output("a")
    assert out.shape == (cfg.n_motions, cfg.motion_feat_dim)

    gen = lambda which: torch.Generator().manual_seed(draw_seed(42, 0, which))
    mT = torch.randn(cfg.n_motions, cfg.motion_feat_dim, generator=gen(0))
    z = torch.randn(cfg.n_diff_steps, cfg.n_motions, cfg.motion_feat_dim, generator=gen(1))
    ref = infer_coeffs(model, audio, np.zeros((1, cfg.shape_feat_dim), np.float32), audio_unit=cfg.audio_unit,
                       style_feats=style[None], dynamic_threshold=None, motion_at_T=mT[None],
                       noise_override=z[:, None], device="cpu")
    np.testing.assert_allclose(out, ref[0].numpy(), rtol=1e-5, atol=1e-5)


def test_stream_isolation(pair):
    _, _, model, cfg = pair
    audio, style = _audio(cfg, 2, seed=9), _style(cfg, 1)

    def run(with_others):
        bat = _batcher(model, 3)
        bat.add_stream("x", 7, style=style)
        bat.push_audio("x", audio, final=True)
        if with_others:
            for j, sid in enumerate(["o1", "o2"]):
                bat.add_stream(sid, 200 + j, style=_style(cfg, 10 + j))
                bat.push_audio(sid, _audio(cfg, 2, seed=20 + j), final=True)
        bat.run_until_drained()
        return bat.output("x")

    np.testing.assert_allclose(run(False), run(True), rtol=1e-5, atol=1e-6)


def test_multi_window_carry_and_noise_reuse(pair):
    _, _, model, cfg = pair
    audio, style = _audio(cfg, 2, seed=11), _style(cfg, 2)
    bat = _batcher(model, 1)
    bat.add_stream("s", 3, style=style)
    bat.push_audio("s", audio, final=True)
    assert bat.step() == 1 and not bat.finished("s")
    w0 = bat.output("s").copy()
    prev_motion, prev_audio, motion_at_T = bat.stream_carry("s")
    np.testing.assert_array_equal(prev_motion, w0[-cfg.n_prev_motions:])
    assert prev_audio.shape == (cfg.n_prev_motions, cfg.feature_dim)
    mT0 = torch.randn(cfg.n_motions, cfg.motion_feat_dim, generator=torch.Generator().manual_seed(draw_seed(3, 0, 0)))
    np.testing.assert_array_equal(motion_at_T, mT0.numpy())  # reused, not redrawn
    assert bat.step() == 1 and bat.finished("s")
    full = bat.output("s")
    assert full.shape == (2 * cfg.n_motions, cfg.motion_feat_dim)

    bat2 = _batcher(model, 1)
    bat2.add_stream("s", 3, style=style)
    bat2.push_audio("s", audio, final=True)
    bat2.step()
    bat2.set_stream_carry("s", prev_motion=bat2.stream_carry("s")[0] + 1.0)
    bat2.step()
    assert not np.allclose(bat2.output("s")[cfg.n_motions:], full[cfg.n_motions:])


def test_partial_final_window_trim(pair):
    _, _, model, cfg = pair
    audio = _audio(cfg, 1, seed=13, extra_samples=int(cfg.audio_unit * 3))  # 3 frames into window 2
    bat = _batcher(model, 2)
    bat.add_stream("p", 5, style=_style(cfg, 3))
    bat.push_audio("p", audio, final=True)
    bat.run_until_drained()
    assert bat.finished("p")
    assert bat.output("p").shape == (cfg.n_motions + 3, cfg.motion_feat_dim)


def test_round_robin_oversubscription(pair):
    _, _, model, cfg = pair
    bat = _batcher(model, 2)
    for i in range(5):
        bat.add_stream(f"s{i}", i, style=_style(cfg, i))
        bat.push_audio(f"s{i}", _audio(cfg, 1, seed=i), final=True)
    rounds = 0
    while any(not bat.finished(f"s{i}") for i in range(5)):
        assert 0 < bat.step() <= 2
        rounds += 1
        assert rounds <= 10
    assert rounds == 3
    for i in range(5):
        assert bat.output(f"s{i}").shape == (cfg.n_motions, cfg.motion_feat_dim)


def test_eviction_carry_roundtrip(pair):
    _, _, model, cfg = pair
    bat = _batcher(model, 2)
    for i in range(3):
        bat.add_stream(f"s{i}", 40 + i, style=_style(cfg, 40 + i))
        bat.push_audio(f"s{i}", _audio(cfg, 2, seed=40 + i), final=True)
    assert bat.run_until_drained() == 6
    assert any(s.prev_motion is not None for s in bat._streams.values()), "no stream was evicted"
    for i in range(3):
        want = _alone(model, cfg, 40 + i, _style(cfg, 40 + i), _audio(cfg, 2, seed=40 + i), 2)
        np.testing.assert_allclose(bat.output(f"s{i}"), want, rtol=1e-5, atol=1e-6)


def test_stream_carry_migration(pair):
    _, _, model, cfg = pair
    style, audio, n_a = _style(cfg, 77), _audio(cfg, 2, seed=77), cfg.n_audio_samples
    stay = _batcher(model, 1)
    stay.add_stream("s", 77, style=style)
    stay.push_audio("s", audio, final=True)
    assert stay.step() == 1
    carry = stay.stream_carry("s")

    mig = _batcher(model, 1)
    mig.add_stream("s", 77, style=style)
    mig._streams["s"].window_idx = stay._streams["s"].window_idx
    mig.set_stream_carry("s", *carry)
    mig.push_audio("s", audio[n_a:], final=True)
    mig.step()
    stay.step()
    np.testing.assert_array_equal(stay.output("s")[cfg.n_motions:], mig.output("s"))


def test_pipeline_depth_output_equality(pair):
    _, _, model, cfg = pair

    def run(depth):
        bat = _batcher(model, 2, pipeline_depth=depth)
        for i in range(2):
            bat.add_stream(f"s{i}", 60 + i, style=_style(cfg, 60 + i))
            bat.push_audio(f"s{i}", _audio(cfg, 3, seed=60 + i), final=True)
        assert bat.run_until_drained() == 6
        assert all(bat.finished(f"s{i}") for i in range(2))
        return [bat.output(f"s{i}") for i in range(2)]

    for a, b in zip(run(1), run(3)):
        np.testing.assert_array_equal(a, b)


def test_waiting_stream_keeps_its_carry(pair):
    """A stream that holds a slot but has no window ready sits out a
    round; its carry on the card is left as it was."""
    _, _, model, cfg = pair
    n_a, style = cfg.n_audio_samples, _style(cfg, 90)
    audio = _audio(cfg, 2, seed=90)
    bat = _batcher(model, 2)
    bat.add_stream("w", 90, style=style)
    bat.add_stream("o", 91, style=_style(cfg, 91))
    bat.push_audio("w", audio[:n_a])
    bat.push_audio("o", _audio(cfg, 2, seed=91), final=True)
    assert bat.step() == 2
    assert bat.step() == 1  # only "o": "w" waits for audio in its slot
    bat.push_audio("w", audio[n_a:], final=True)
    bat.run_until_drained()
    np.testing.assert_allclose(bat.output("w"), _alone(model, cfg, 90, style, audio, 2), rtol=1e-5, atol=1e-6)


def test_matches_jax_batcher_with_replayed_draws(pair, monkeypatch):
    from msmd_tpu.serving import StreamingBatcher as JaxBatcher

    jm, jv, model, cfg = pair
    T, L, D = cfg.n_diff_steps, cfg.n_motions, cfg.motion_feat_dim

    def jax_draw(self, stream, window, z_out):
        k_w = jax.random.fold_in(jax.random.PRNGKey(stream.seed), window)
        z_out.copy_(torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(k_w, 1), (T, L, D)))))
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(k_w, 0), (L, D))))

    monkeypatch.setattr(StreamingBatcher, "_draw", jax_draw)
    streams = {"a": (11, _audio(cfg, 2, seed=31)),
               "b": (12, _audio(cfg, 1, seed=32, extra_samples=int(cfg.audio_unit * 5)))}
    jbat = JaxBatcher(jm, {"params": jv["params"]}, max_slots=2)
    tbat = _batcher(model, 2)
    for sid, (seed, audio) in streams.items():
        jbat.add_stream(sid, jax.random.PRNGKey(seed), style=_style(cfg, seed))
        tbat.add_stream(sid, seed, style=_style(cfg, seed))
        for bat in (jbat, tbat):
            bat.push_audio(sid, audio, final=True)
    assert jbat.run_until_drained() == tbat.run_until_drained() == 4
    for sid in streams:
        want, got = jbat.output(sid), tbat.output(sid)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("slots,resident,want", [
    (1, False, {"scan": 1}),
    (2, False, {"flat": 4, "k1": 4}),
    (4, False, {"k1": 4}),
    (4, True, {"k2": 4}),
])
def test_slot_count_selects_the_decoder_kernel(monkeypatch, slots, resident, want):
    from msmd_tpu_torch.ops.kernels import decoder as tdk
    from msmd_tpu_torch.ops.kernels import decoder_resident as tdr
    from msmd_tpu_torch.ops.kernels import sampler as tks

    counts = {}
    counting_spy(monkeypatch, tks, "fused_sampler_scan", counts, "scan")
    counting_spy(monkeypatch, tdk, "fused_decoder_forward", counts, "k1")
    counting_spy(monkeypatch, tdk, "fused_decoder_forward_flat", counts, "flat")
    counting_spy(monkeypatch, tdr, "fused_decoder_forward_resident", counts, "k2")
    _, _, model, kw = build_msmd_pair("bfloat16", seed=51)
    cfg = model.cfg
    assert cfg.n_diff_steps == 4 and 1 + cfg.n_prev_motions + cfg.n_motions == 16
    bat = _batcher(model, slots, resident=resident)
    for i in range(slots):
        bat.add_stream(f"s{i}", i, style=_style(cfg, i))
        bat.push_audio(f"s{i}", _audio(cfg, 1, seed=i), final=True)
    assert bat.step() == slots
    assert counts == {"scan": 0, "k1": 0, "flat": 0, "k2": 0, **want}
    for i in range(slots):
        out = bat.output(f"s{i}")
        assert out.shape == (cfg.n_motions, cfg.motion_feat_dim) and np.isfinite(out).all()
