"""The frozen yardstick (``h100bench/work.py``) equals the port's own
counts at the flagship shapes today, so a later change to the port's
``measure.py`` cannot move it unseen."""

import pytest
import torch

from h100bench import work


def test_decoder_work_equals_the_ports_count_at_batch_48():
    from msmd_tpu_torch import measure

    assert work.decoder_work(96, 111) == measure.decoder_work(measure.decoder_case("cpu"))


def test_sampler_work_equals_the_ports_count_at_batch_1():
    from msmd_tpu_torch import measure

    scan, _, kw = measure.sampler_case("cpu")
    assert work.sampler_work() == measure.sampler_work(scan, kw)


@pytest.mark.parametrize("frames", [100, 4800])
def test_lbs_work_equals_the_ports_count(frames):
    from msmd_tpu_torch import measure

    fused, (betas_ext, rt) = measure.lbs_case("cpu", N=frames)
    assert work.lbs_work(frames) == measure.lbs_work(fused, betas_ext, rt)


@pytest.mark.parametrize("backward", [False, True])
def test_ffn_train_work_equals_the_ports_count(backward):
    from msmd_tpu_torch.ops.kernels.ffn_train import ffn_train_work

    assert work.ffn_train_work(1776, backward=backward) == ffn_train_work(1776, 512, 2048, backward)
    assert work.ffn_train_work(3552, backward=backward) == ffn_train_work(3552, 512, 2048, backward)


def test_peaks_are_the_data_sheets():
    from msmd_tpu_torch import measure

    assert (work.BF16_PEAK, work.TF32_PEAK, work.F32_PEAK, work.HBM_RATE) == (
        measure.BF16_PEAK, measure.TF32_PEAK, measure.F32_PEAK, measure.HBM_RATE)


def test_bounds_at_the_flagship_shapes():
    assert work.bound_s(*work.decoder_work(96, 111)) * 1e3 == pytest.approx(0.5629, abs=1e-4)
    assert work.bound_s(*work.sampler_work()) * 1e3 == pytest.approx(5.897, abs=1e-3)
    assert work.lbs_bound_s(4800) * 1e3 == pytest.approx(0.1631, abs=1e-4)


def test_conv_lengths_follow_the_ports_audio_encoder():
    """The strided stack's frame count, as the port's encoder gives it,
    at the padded length of a 4 s and a 14.5 s clip."""
    from msmd_tpu_torch.config import AudioEncoderConfig
    from msmd_tpu_torch.models.audio import ConvFeatureExtractor
    from msmd_tpu_torch.ops.seq import pad_audio

    c = AudioEncoderConfig(conv_dim=(4,) * 7)
    fx = ConvFeatureExtractor(c)
    for n in (64000, 256000):
        padded = pad_audio(torch.zeros(1, n))
        assert padded.shape[1] == work.pad_audio_len(n)
        with torch.no_grad():
            assert fx(padded).shape[1] == work.conv_lengths(padded.shape[1], c.conv_kernel, c.conv_stride)[-1]


def test_window_flops_hold_the_decoder_stack_and_grow_with_the_batch():
    one, many = work.window_flops(1, 2), work.window_flops(48, 2)
    assert one > 500 * work.decoder_work(2, 111)[0]
    assert many == pytest.approx(48 * one, rel=1e-9)
