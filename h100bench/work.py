"""The yardstick: operations and bytes of the work a cell asks for, and
the H100's published peaks.

The kernel counts are frozen copies of the counts the port kept in
``msmd_tpu_torch/measure.py`` and ``ops/kernels/ffn_train.py`` when this
benchmark was written (``decoder_work``, ``sampler_work``, ``lbs_work``,
``ffn_train_work``), restated over shapes so that no program tensor is
read: whatever implements a kernel later, its roofline is read against
the same work. A bound counts each input read once and each output
written once. The model's operations for ``mfu`` count every product of
the forward pass as the published model defines it (two operations a
multiply-add), once each: work that a kernel does once for a whole window
(the memory's keys and values, the cross out-projection of the motion
rows under the width-1 band) counts once a window.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
BF16_PEAK = 989e12
TF32_PEAK = 495e12
F32_PEAK = 67e12
HBM_RATE = 3.35e12

BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float, peak: float = BF16_PEAK) -> float:
    """The least seconds the chip could take: operations at ``peak`` or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / peak, nbytes / HBM_RATE)


def _pack_bytes(F: int, L: int, FF: int) -> int:
    """A decoder stack's packed weights: bf16 products and biases, f32
    LayerNorm scales and biases (three a layer)."""
    per_layer = (F * 3 * F + 3 * F + 3 * (F * F + F) + F * FF + FF + FF * F + F) * BF16 + 2 * 3 * F * F32
    return L * per_layer


def decoder_work(Be: int, lq: int, F: int = 512, H: int = 8, L: int = 8, FF: int = 2048):
    """(flops, bytes) of one call of K1 per-entry over Be entries of lq
    rows (``measure.decoder_work``): QKV, self-out and the FFN over every
    row, per-entry self-attention, the person rows' cross query, output
    and attention; the packed weights, the memory's K and V (bf16), the
    motion rows' cross values through the output projection (bf16), the
    rows in and out (f32) and the entry index (int32)."""
    R, lm, dh = Be * lq, lq - 1, F // H
    per_layer = (2 * R * F * 3 * F + 2 * R * F * F + 2 * R * F * FF * 2
                 + 2 * 2 * Be * H * lq * lq * dh
                 + 2 * Be * F * F * 2 + 2 * 2 * Be * H * lm * dh)
    nbytes = (_pack_bytes(F, L, FF) + 2 * L * Be * lm * F * BF16 + L * R * F * BF16
              + 2 * R * F * F32 + Be * 4)
    return L * per_layer, nbytes


def sampler_work(T: int = 500, E: int = 2, N: int = 100, P: int = 10, F: int = 512, H: int = 8, L: int = 8,
                 FF: int = 2048, D: int = 67, K: int = 4, Fd: int = 256, Din: int = 68):
    """(flops, bytes) of one call of K3, a whole batch-1 window of T steps
    over E guidance entries of lq = 1 + P + N rows (``measure.sampler_work``):
    per step the decoder stack (the person rows' cross output only), the
    memory's keys through the feature projection, and the motion decoder;
    the weights and tables read once, the motion written once."""
    lq = 1 + P + N
    R, lm, dh = E * lq, lq - 1, F // H
    per_layer = (2 * R * F * 3 * F + 2 * R * F * F + 2 * R * F * FF * 2
                 + 2 * 2 * E * H * lq * lq * dh
                 + 2 * E * F * F + 2 * 2 * E * H * lm * dh
                 + 2 * E * F * F)
    per_step = L * per_layer + 2 * lm * Din * F + 2 * E * N * F * Fd + 2 * E * N * Fd * (D + K)
    const = (P * Din * F32 + N * F32 + Din * F * BF16 + F * F32 + E * F * F32 + E * lq * F * F32
             + F * Fd * BF16 + Fd * F32 + Fd * (D + K) * BF16 + (D + K) * F32
             + K * E * N * D * F32 + E * N * 3 * F32 + L * E * lq * F * F32)
    tables = 2 * L * E * lm * F * BF16 + N * D * F32 + T * F * F32 + T * 8 * F32 + T * N * D * F32
    return T * per_step, _pack_bytes(F, L, FF) + const + tables + N * D * F32


def lbs_work(N: int, V: int = 5023, KB: int = 186, J: int = 5):
    """(blend flops, skinning flops, bytes) of one call of K5 over N
    frames (``measure.lbs_work``): the blend product once (its three TF32
    products are the kernel's way to f32 accuracy), the skinning on the
    CUDA cores, the inputs read once and the vertices written once."""
    blend = N * V * 3 * 2 * KB
    skin = N * V * J * (3 * 7 + 3 * 2)
    nbytes = F32 * (N * KB + N * 12 * J + 3 * KB * V + 3 * V + J * V + N * V * 3)
    return blend, skin, nbytes


def lbs_bound_s(N: int, V: int = 5023, KB: int = 186) -> float:
    """K5's bound at f32 accuracy: three TF32 products of the blend, the
    skinning on the f32 CUDA cores, or the bytes."""
    blend, skin, nbytes = lbs_work(N, V, KB)
    return max(3 * blend / TF32_PEAK, skin / F32_PEAK, nbytes / HBM_RATE)


def ffn_train_work(rows: int, F: int = 512, FF: int = 2048, backward: bool = False):
    """(flops, bytes) of one K7 forward or backward call
    (``ffn_train.ffn_train_work``): 2 or 6 products of 2 rows F FF; bf16
    weights, f32 LayerNorm parameters, each input read once, each output
    written once."""
    flops = (6 if backward else 2) * 2 * rows * F * FF
    weights = 2 * F * FF * BF16 + (FF + F) * BF16 + 2 * F * F32
    acts = rows * F * BF16
    if backward:
        nbytes = 2 * acts + weights + acts + 2 * F * FF * BF16 + (FF + F) * BF16 + 2 * F * F32
    else:
        nbytes = acts + weights + acts
    return flops, nbytes


# ---------------------------------------------------------------------------
# the model's operations, for mfu
# ---------------------------------------------------------------------------

def conv_lengths(n_samples: int, kernels, strides):
    """Output lengths of the strided convolution stack."""
    out, n = [], n_samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
        out.append(n)
    return out


def pad_audio_len(n: int, unit: int = 320, threshold: int = 80) -> int:
    """Length of the audio after the reference's symmetric padding."""
    side = -(-(unit * (n // unit) + threshold - n) // 2)
    if side < 0:
        return n
    return n + 4 * (side // 2) + 2 * (side % 2)


def hubert_parts(n_samples: int, frames: int, arch: dict) -> dict:
    """HuBERT-base over one clip of ``n_samples`` (before padding),
    encoded at ``frames`` frames, by part: the convolutions at their
    lengths with the feature projection (``front``), the positional
    convolution (``pos``) and one encoder layer with its attention
    (``layer``)."""
    dims = list(arch["conv_dim"])
    cin = [1] + dims[:-1]
    lens = conv_lengths(pad_audio_len(n_samples), arch["conv_kernel"], arch["conv_stride"])
    conv = sum(2 * n * co * ci * k for n, co, ci, k in zip(lens, dims, cin, arch["conv_kernel"]))
    Hd, I, G, Kp = arch["hidden_size"], arch["intermediate_size"], arch["num_conv_pos_embedding_groups"], \
        arch["num_conv_pos_embeddings"]
    T = frames
    proj = 2 * T * dims[-1] * Hd
    return dict(front=conv + proj, pos=2 * T * Hd * (Hd // G) * Kp,
                layer=2 * T * (4 * Hd * Hd + 2 * Hd * I) + 2 * 2 * T * T * Hd)


def hubert_flops(n_samples: int, frames: int, arch: dict) -> int:
    """HuBERT-base over one clip (``hubert_parts``), every part once."""
    p = hubert_parts(n_samples, frames, arch)
    return p["front"] + p["pos"] + arch["num_layers"] * p["layer"]


def audio_feature_flops(n_samples: int, frame_num: int, arch: dict, F: int = 512) -> int:
    """``extract_audio_feature``: HuBERT at twice the frames, then the map
    to F."""
    return hubert_flops(n_samples, 2 * frame_num, arch) + 2 * frame_num * arch["hidden_size"] * F


def style_flops(T: int = 100, D: int = 67, C: int = 512, d_style: int = 256) -> int:
    """The VAE2 style encoder on one clip of T frames."""
    out = 2 * d_style
    convs = 2 * T * 3 * (D * C + C * C + C * out + out * out)
    layer = 2 * T * (4 * C * C + 2 * C * C) + 2 * 2 * T * T * C
    return convs + layer


def window_flops(B: int, E: int, n: int = 100, P: int = 10, F: int = 512, H: int = 8, L: int = 8,
                 FF: int = 2048, T: int = 500, D: int = 67, K: int = 4, d_style: int = 256,
                 d_shape: int = 100) -> int:
    """One sampling window of B sequences and E guidance entries: T
    denoiser calls over Be = B E entries (the decoder stack as K1 counts
    it, the feature and person projections, the step MLP, the motion
    decoder, the style bases), and once a window the memory's keys and
    values and the motion rows' cross output through its projection."""
    Be, lq = B * E, 1 + P + n
    dec_flops, _ = decoder_work(Be, lq, F, H, L, FF)
    rows = P + n
    per_step = (dec_flops + 2 * Be * rows * (D + 1) * F + 2 * Be * (d_shape + d_style) * F + 2 * 2 * Be * F * F
                + 2 * Be * rows * (F * F // 2 + F // 2 * (D + K)) + K * 2 * Be * (d_style * F + F * D))
    once = L * (2 * 2 * Be * rows * F * F + 2 * Be * rows * F * F)
    return T * per_step + once


def lbs_flops(N: int, V: int = 5023, KB: int = 186) -> int:
    """The FLAME decode of N frames (K5's work)."""
    blend, skin, _ = lbs_work(N, V, KB)
    return blend + skin


def denoiser_train_flops(N: int, n: int = 100, P: int = 10, F: int = 512, H: int = 8, L: int = 8, FF: int = 2048,
                         D: int = 67, K: int = 4, d_style: int = 256, d_shape: int = 100) -> int:
    """One training forward of the denoiser over N entries (no cache): per
    layer QKV, self-out, the memory's keys and values, the person row's
    cross query, the cross output over every row, the FFN, self-attention
    and the person row's attention; the step MLP, the projections in, the
    motion decoder and the style bases."""
    lq, lm = 1 + P + n, P + n
    per_layer = (2 * lq * (3 * F * F + F * F + F * F + 2 * F * FF) + 2 * lm * 2 * F * F + 2 * F * F
                 + 2 * 2 * lq * lq * F + 2 * 2 * lm * F)
    rest = (2 * 2 * F * F + 2 * (d_shape + d_style) * F + 2 * lm * (D + 1) * F
            + 2 * lm * (F * F // 2 + F // 2 * (D + K)) + K * 2 * (d_style * F + F * D))
    return N * (L * per_layer + rest)


def train_step_flops(B: int, arch: dict, n: int = 100, P: int = 10, F: int = 512, frozen_layers: int = 2) -> int:
    """A two-clip training step at batch B (2B entries): the forward of
    every part (the style encoder, HuBERT at twice the frames, the
    denoiser, four FLAME decodes for the vertex loss), and the backward:
    twice the forward for the parts that train (weights and inputs), once
    for HuBERT's frozen layers 0 and 1 (their inputs' gradient reaches the
    trained mask embedding), once for the two decodes of the prediction,
    none for the frozen convolutions and projection."""
    N = 2 * B
    hp = hubert_parts(round(640 * n), 2 * n, arch)
    trained_audio = hp["pos"] + (arch["num_layers"] - frozen_layers) * hp["layer"] + 2 * n * arch["hidden_size"] * F
    frozen_audio = frozen_layers * hp["layer"]
    fwd = N * (hp["front"] + frozen_audio + trained_audio + style_flops(n)) + denoiser_train_flops(N, n, P, F)
    decode = lbs_flops(B * (n + (P + n)))  # both clips' frames, once for the truth and once for the prediction
    bwd = N * (2 * (trained_audio + style_flops(n)) + frozen_audio) + 2 * denoiser_train_flops(N, n, P, F) + decode
    return fwd + 2 * decode + bwd
