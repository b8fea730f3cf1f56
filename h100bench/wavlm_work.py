"""The yardstick of the WavLM-Large cell: the operations of its training
step (for ``mfu``) and the operations and bytes of K10, the gated
relative-position attention (for ``k10_roofline``), restated over shapes
so that no program tensor is read: whatever implements K10 later, its
roofline is read against the same work. The conventions are
``work.py``'s: products at two operations a multiply-add, a bound counts
each input read once and each output written once.
"""

from __future__ import annotations

from h100bench import work

GATE_WIDTH = 8  # gru_rel_pos_linear: head width -> 8


def k10_work(entries: int, L: int, heads: int = 16, dh: int = 64, backward: bool = False):
    """(flops, bytes) of K10 over ``entries`` sequences of L rows. Forward:
    QK^T and PV; q, k, v read and the output written in bf16, the gate read
    and the rows' log-sum-exp written in f32. Backward: the five products
    the inputs need (QK^T again, dP = dO V^T, dV = P^T dO, dQ = dS K,
    dK = dS^T Q); q, k, v, the output and its gradient read, dq, dk, dv
    written in bf16, the gate and the log-sum-exp read and dg written in
    f32. The heads' table of offsets (and dr), H (2L - 1) floats a call,
    is left out: a thousandth of a call's bytes at L = 200, B = 32."""
    rows = entries * heads * L
    flops = (5 if backward else 2) * 2 * rows * L * dh
    nbytes = (8 if backward else 4) * rows * dh * work.BF16 + (3 if backward else 2) * rows * work.F32
    return flops, nbytes


def k10_bound_s(fwd_rows: int, bwd_rows: int, L: int, heads: int = 16, dh: int = 64) -> float:
    """The least seconds of K10's forward calls over ``fwd_rows`` query
    rows (entries times L, summed over calls) and its backward calls over
    ``bwd_rows``, at L rows a sequence."""
    return (work.bound_s(*k10_work(fwd_rows // L, L, heads, dh))
            + work.bound_s(*k10_work(bwd_rows // L, L, heads, dh, backward=True)))


def wavlm_parts(n_samples: int, frames: int, arch: dict) -> dict:
    """WavLM over one clip of ``n_samples`` (before padding), encoded at
    ``frames`` frames, by part: the convolutions (``front``; their
    LayerNorms and biases are no products), the feature projection
    (``proj``), the positional convolution (``pos``, over the T + 1
    positions that its 'same' padding of an even kernel makes, the last
    dropped) and one layer
    (``layer``: the four attention projections, the FFN, the gate's 64 -> 8
    projection per head, and the attention's two products)."""
    dims = list(arch["conv_dim"])
    cin = [1] + dims[:-1]
    lens = work.conv_lengths(work.pad_audio_len(n_samples), arch["conv_kernel"], arch["conv_stride"])
    conv = sum(2 * n * co * ci * k for n, co, ci, k in zip(lens, dims, cin, arch["conv_kernel"]))
    Hd, I, G, Kp = arch["hidden_size"], arch["intermediate_size"], arch["num_conv_pos_embedding_groups"], \
        arch["num_conv_pos_embeddings"]
    T = frames
    T_pos = T + 2 * (Kp // 2) - Kp + 1
    return dict(front=conv, proj=2 * T * dims[-1] * Hd, pos=2 * T_pos * Hd * (Hd // G) * Kp,
                layer=2 * T * (4 * Hd * Hd + 2 * Hd * I) + 2 * T * Hd * GATE_WIDTH + 2 * 2 * T * T * Hd)


def audio_feature_flops(n_samples: int, frame_num: int, arch: dict, F: int = 512) -> int:
    """``extract_audio_feature`` with WavLM: the encoder at twice the
    frames, then the map to F."""
    p = wavlm_parts(n_samples, 2 * frame_num, arch)
    return p["front"] + p["proj"] + p["pos"] + arch["num_layers"] * p["layer"] + 2 * frame_num * arch[
        "hidden_size"] * F


def train_step_flops(B: int, arch: dict, n: int = 100, P: int = 10, F: int = 512) -> int:
    """A two-clip training step at batch B (2B clips) with WavLM as the
    speech encoder, as ``work.train_step_flops`` counts it: the forward of
    every part, and the backward at twice the forward for the parts that
    train (every part of WavLM but its frozen convolutions, whose input
    takes no gradient), once for the two decodes of the prediction."""
    N = 2 * B
    wp = wavlm_parts(round(640 * n), 2 * n, arch)
    trained = wp["proj"] + wp["pos"] + arch["num_layers"] * wp["layer"] + 2 * n * arch["hidden_size"] * F
    fwd = N * (wp["front"] + trained + work.style_flops(n)) + work.denoiser_train_flops(N, n, P, F)
    decode = work.lbs_flops(B * (n + (P + n)))
    bwd = N * 2 * (trained + work.style_flops(n)) + 2 * work.denoiser_train_flops(N, n, P, F) + decode
    return fwd + 2 * decode + bwd
