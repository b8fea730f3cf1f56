"""A plain PyTorch reference of MSMD's inference path, written from the
published description (MSMD, "Model See Model Do"; DiffPoseTalk's
denoiser; HuBERT-base; FLAME's linear blend skinning), independent of the
program: it imports nothing of the port or of the JAX package.

Every function reads the weights from a flat dict keyed by the parameter
names the benchmark loads into the port (``audio_encoder.*``,
``denoising_net.*``, the style encoder's ``input_layers.*``), and computes
in float32 with TF32 off, or in the precision its ``Prec`` names (the
control). Departures from the published models, kept because the
program has them too: the audio features are taken at 50 Hz for twice the
motion frames and resampled linearly; the style encoder adds the
sinusoidal table's row at the sequence length to every position; the
classifier-free-guidance entries whose coefficient is exactly zero are
not computed (they add nothing).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.precision import Prec

W = Dict[str, torch.Tensor]
LN_EPS = 1e-5


def layer_norm(w: W, p: str, x):
    return F.layer_norm(x.float(), (x.shape[-1],), w[p + ".weight"].float(), w[p + ".bias"].float(), LN_EPS)


def dense(w: W, p: str, x, prec: Prec):
    return prec.linear(x, w[p + ".weight"], w.get(p + ".bias"))


def gelu(x):
    return F.gelu(x, approximate="none")


def sinusoid(d_model: int, max_len: int, device) -> torch.Tensor:
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pos = np.arange(0, max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe, device=device)


def resample(x, out_len: int):
    """Linear resampling along time of (N, L, C), half-pixel centres
    (``F.interpolate(mode="linear", align_corners=False)``), the source
    coordinates in float32."""
    n = x.shape[1]
    if n == out_len:
        return x
    src = (np.arange(out_len, dtype=np.float32) + np.float32(0.5)) * np.float32(n / out_len) - np.float32(0.5)
    src = np.clip(src, np.float32(0.0), np.float32(n - 1))
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    wt = torch.as_tensor(src - i0.astype(np.float32), device=x.device)[None, :, None]
    a, b = x[:, torch.as_tensor(i0, device=x.device)], x[:, torch.as_tensor(i1, device=x.device)]
    return a + (b - a) * wt


def pad_audio(audio, unit: int = 320, threshold: int = 80):
    """Symmetric padding so that the strided convolutions give whole
    frames: reflect twice by half the side, one replicated sample when
    the side is odd (the reference's ``pad_audio``)."""
    n = audio.shape[1]
    side = math.ceil((unit * (n // unit) + threshold - n) / 2)
    if side < 0:
        return audio
    x = audio[:, None]
    if side // 2 > 0:
        x = F.pad(x, (side // 2,) * 2, mode="reflect")
        x = F.pad(x, (side // 2,) * 2, mode="reflect")
    if side % 2:
        x = F.pad(x, (1, 1), mode="replicate")
    return x[:, 0]


# ---------------------------------------------------------------------------
# HuBERT-base
# ---------------------------------------------------------------------------

def hubert(w: W, audio, frame_num: int, fps: int, arch: dict, prec: Prec):
    """Padded 16 kHz audio (N, L) -> (N, frame_num, hidden): the strided
    convolutions (GELU; a per-channel GroupNorm after the first), the
    first ``frame_num * 50 / fps`` frames resampled to ``frame_num``, the
    feature projection, the grouped positional convolution and the
    post-LN encoder layers."""
    p = "audio_encoder."
    h = audio[:, None].float()
    for i, s in enumerate(arch["conv_stride"]):
        h = prec.conv1d(h, w[f"{p}feature_extractor.conv.{i}.weight"], stride=s)
        if i == 0:
            mu = h.mean(dim=2, keepdim=True)
            var = ((h - mu) ** 2).mean(dim=2, keepdim=True)
            gn = p + "feature_extractor.group_norm"
            h = (h - mu) * torch.rsqrt(var + LN_EPS) * w[gn + ".weight"][:, None] + w[gn + ".bias"][:, None]
        h = gelu(h)
    h = h.transpose(1, 2)[:, :round(frame_num * 50 / fps)]
    h = resample(h, frame_num)
    h = dense(w, p + "feature_projection.projection", layer_norm(w, p + "feature_projection.layer_norm", h), prec)
    k = arch["num_conv_pos_embeddings"]
    pos = prec.conv1d(h.transpose(1, 2), w[p + "encoder.pos_conv_embed.conv.weight"],
                      w[p + "encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                      groups=arch["num_conv_pos_embedding_groups"]).transpose(1, 2)
    if k % 2 == 0:
        pos = pos[:, :-1]
    x = layer_norm(w, p + "encoder.layer_norm", h + gelu(pos))
    heads = arch["num_heads"]
    for i in range(arch["num_layers"]):
        lp = f"{p}encoder.layers.{i}."
        a = attention(w, lp + "q_proj", lp + "k_proj", lp + "v_proj", x, x, heads, None, prec)
        x = layer_norm(w, lp + "layer_norm", x + dense(w, lp + "out_proj", a, prec))
        f = dense(w, lp + "output_dense", gelu(dense(w, lp + "intermediate_dense", x, prec)), prec)
        x = layer_norm(w, lp + "final_layer_norm", x + f)
    return x


def audio_features(w: W, audio, frame_num: int, fps: int, arch: dict, prec: Prec):
    """z-scored 16 kHz audio (N, L) -> (N, frame_num, feature_dim):
    HuBERT at twice the frames, resampled, projected."""
    h = hubert(w, pad_audio(audio.float()), 2 * frame_num, fps, arch, prec)
    return dense(w, "audio_feature_map", resample(h, frame_num), prec)


def attention(w: W, pq: str, pk: str, pv: str, xq, xkv, heads: int, mask, prec: Prec):
    """Multi-head attention before the output projection; ``mask`` True
    where a query may not look."""
    B, Lq, Fd = xq.shape
    dh = Fd // heads
    q = dense(w, pq, xq, prec).reshape(B, Lq, heads, dh)
    k = dense(w, pk, xkv, prec).reshape(B, xkv.shape[1], heads, dh)
    v = dense(w, pv, xkv, prec).reshape(B, xkv.shape[1], heads, dh)
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if mask is not None:
        s = s.masked_fill(mask, float("-inf"))
    return prec.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v).reshape(B, Lq, Fd)


# ---------------------------------------------------------------------------
# the style encoder (VAE2)
# ---------------------------------------------------------------------------

def style_mean(w: W, clip, prec: Prec, heads: int = 8):
    """Style clip (N, T, 67) -> the posterior mean (N, d_style): two
    (conv k3, ELU, LayerNorm) blocks, one post-LN encoder layer, a conv
    head (ELU, LayerNorm, conv), the mean over time, the first half."""
    x = clip.float()
    conv = lambda p, t: prec.conv1d(t.transpose(1, 2), w[p + ".weight"], w[p + ".bias"], padding=1).transpose(1, 2)
    for i in range(2):
        x = layer_norm(w, f"input_layers.norm.{i}", F.elu(conv(f"input_layers.conv.{i}", x)))
    x = x + sinusoid(x.shape[-1], 600, x.device)[x.shape[1]]
    a = attention(w, "encoder.self_attn.q_proj", "encoder.self_attn.k_proj", "encoder.self_attn.v_proj", x, x,
                  heads, None, prec)
    x = layer_norm(w, "encoder.norm1", x + dense(w, "encoder.self_attn.out_proj", a, prec))
    f = dense(w, "encoder.ffn.linear2", gelu(dense(w, "encoder.ffn.linear1", x, prec)), prec)
    x = layer_norm(w, "encoder.norm2", x + f)
    x = layer_norm(w, "out_norm", F.elu(conv("out_conv.0", x)))
    out = conv("out_conv.1", x).mean(dim=1)
    return out[:, :out.shape[1] // 2]


# ---------------------------------------------------------------------------
# the denoiser
# ---------------------------------------------------------------------------

def alignment_mask(n_prev: int, n_cur: int, width: int, device):
    """True where a token may not look at a memory row: the person token
    sees every row; motion token i + 1 sees rows i - (width - 1) .. i."""
    n = n_prev + n_cur
    r = torch.arange(n, device=device)[:, None]
    c = torch.arange(n, device=device)[None, :]
    band = ~((c >= (r - (width - 1)).clamp_min(0)) & (c < r + width))
    return torch.cat([torch.zeros(1, n, dtype=torch.bool, device=device), band])


def denoise(w: W, cfg: dict, motion, audio_feat, person, style, prev_motion, prev_audio, t: int, indicator,
            prec: Prec):
    """One denoiser call in eval mode: (N, L, 67) noisy motion -> the
    predicted clean motion of the previous and current frames
    (N, L_p + L, 67)."""
    p = "denoising_net."
    dev = motion.device
    N, L = motion.shape[:2]
    Lp = prev_motion.shape[1]
    Fd, T = cfg["feature_dim"], cfg["n_diff_steps"]
    emb = sinusoid(Fd, T + 1, dev)[t][None].expand(N, Fd)
    emb = dense(w, p + "diff_step_map.linear2", gelu(dense(w, p + "diff_step_map.linear1", emb, prec)), prec)
    tok_p = dense(w, p + "person_proj", person, prec) + emb[:, None]
    feats = torch.cat([prev_motion.float(), motion.float()], dim=1)
    if cfg["use_indicator"]:
        ind = torch.cat([torch.zeros(N, Lp, device=dev), indicator.float()], dim=1)[..., None]
        feats = torch.cat([feats, ind], dim=-1)
    x = torch.cat([tok_p, dense(w, p + "feature_proj", feats, prec)], dim=1) + w[p + "PE"]
    memory = torch.cat([prev_audio.float(), audio_feat.float()], dim=1)
    mask = alignment_mask(Lp, L, cfg["align_mask_width"], dev) if cfg["align_mask_width"] > 0 else None
    H = cfg["n_heads"]
    for i in range(cfg["n_layers"]):
        lp = f"{p}transformer.layers.{i}."
        sa, ca = lp + "self_attn.", lp + "cross_attn."
        a = attention(w, sa + "q_proj", sa + "k_proj", sa + "v_proj", x, x, H, None, prec)
        x = layer_norm(w, lp + "norm1", x + dense(w, sa + "out_proj", a, prec))
        a = attention(w, ca + "q_proj", ca + "k_proj", ca + "v_proj", x, memory, H, mask, prec)
        x = layer_norm(w, lp + "norm2", x + dense(w, ca + "out_proj", a, prec))
        f = dense(w, lp + "ffn.linear2", gelu(dense(w, lp + "ffn.linear1", x, prec)), prec)
        x = layer_norm(w, lp + "norm3", x + f)
    dec = dense(w, p + "motion_dec_2", gelu(dense(w, p + "motion_dec_1", x[:, 1:], prec)), prec)
    K = cfg["num_of_basis"]
    dynamic, alphas = dec[..., :-K], dec[..., -K:]
    static = torch.stack([dense(w, f"{p}static_feature_mapping.{k}.linear2",
                                gelu(dense(w, f"{p}static_feature_mapping.{k}.linear1", style, prec)), prec)
                          for k in range(K)], dim=2)  # (N, 1, K, 67)
    face = (static[..., :-3] * alphas[..., None]).sum(dim=2)
    pose = static[..., -3:].sum(dim=2).expand(N, dec.shape[1], 3)
    return dynamic + torch.cat([face, pose], dim=-1)


# ---------------------------------------------------------------------------
# DDPM sampling with classifier-free guidance, and the windowed clip
# ---------------------------------------------------------------------------

def cosine_schedule(T: int, s: float = 0.008):
    """alphas and alpha-bars indexed 0..T (index 0 the no-noise step), as
    float32 arrays: the cosine betas clipped to [1e-4, 0.999], the bars
    as a cumulative sum of logs."""
    x = np.linspace(0, T, T + 1, dtype=np.float64)
    ab = np.cos(((x / T) + s) / (1 + s) * np.pi * 0.5) ** 2
    ab = ab / ab[0]
    betas = np.clip(1 - (ab[1:] / ab[:-1]), 0.0001, 0.999).astype(np.float32)
    betas = np.concatenate([np.zeros(1, np.float32), betas])
    alphas = (1.0 - betas).astype(np.float32)
    return alphas, np.exp(np.cumsum(np.log(1.0 - betas))).astype(np.float32), betas


def ddpm_coefficients(T: int):
    """(A, B, sigma) of x_{t-1} = A x_t + B x0_pred + sigma z for t = 0..T,
    the posterior of a clean-sample target with its own variance."""
    f32 = np.float32
    al, ab, betas = cosine_schedule(T)
    t = np.arange(T + 1)
    ab_prev = ab[np.maximum(t - 1, 0)]
    denom = np.where(t > 0, f32(1.0) - ab, f32(1.0)).astype(f32)
    A = (f32(1.0) - ab_prev) * np.sqrt(al) / denom
    B = (f32(1.0) - al) * np.sqrt(ab_prev) / denom
    sig = np.zeros(T + 1, f32)
    sig[1:] = np.sqrt(((1 - ab[:-1]) / (1 - ab[1:])) * betas[1:])
    return A.astype(f32), B.astype(f32), sig


def cfg_entries(scale: float):
    """Incremental guidance over (audio, style) at one scale s: entries
    [no condition, audio, audio and style] with coefficients
    [1 - s, s - s, s]; those exactly zero are dropped."""
    coeffs = [1.0 - scale, scale - scale, scale]
    return [(e, c) for e, c in zip(("null", "audio", "both"), coeffs) if c != 0.0]


def sample_window(w: W, cfg: dict, audio_feat, shape, style, prev_motion, prev_audio, x_T, noise, indicator,
                  cfg_scale: float, dynamic_threshold, prec: Prec):
    """One window of DDPM sampling, t = T..1. ``noise`` (T, N, L, 67) is
    the z of each step in order (the last one is not used). Returns the
    clean motion (N, L, 67)."""
    N, L = x_T.shape[:2]
    T = cfg["n_diff_steps"]
    A, Bc, sig = ddpm_coefficients(T)
    null_audio = w["null_audio_feat"].expand(N, L, -1)
    null_person = torch.cat([shape, w["null_style_feat"].expand(N, 1, -1)], dim=-1)
    full_person = torch.cat([shape, style], dim=-1)
    inputs = {"null": (null_audio, null_person), "audio": (audio_feat, null_person),
              "both": (audio_feat, full_person)}
    entries = cfg_entries(cfg_scale)
    E = len(entries)
    tile = lambda t: torch.cat([t] * E, dim=0)
    a_in = torch.cat([inputs[n][0].float() for n, _ in entries], dim=0)
    p_in = torch.cat([inputs[n][1].float() for n, _ in entries], dim=0)
    st, pm, pa, ind = tile(style), tile(prev_motion), tile(prev_audio), tile(indicator)
    x = x_T.float()
    for i, t in enumerate(range(T, 0, -1)):
        r = denoise(w, cfg, tile(x), a_in, p_in, st, pm, pa, t, ind, prec)
        if dynamic_threshold:
            ratio, lo, hi = dynamic_threshold
            s = torch.quantile(r[:, -L:].reshape(E * N, -1).abs(), float(ratio), dim=1).clamp(lo, hi)[:, None, None]
            r = torch.clamp(r, -s, s)
        r = r[:, -L:].reshape(E, N, L, -1)
        target = sum(c * r[e] for e, (_, c) in enumerate(entries))
        z = noise[i] if t > 1 else torch.zeros_like(x)
        x = float(A[t]) * x + float(Bc[t]) * target + float(sig[t]) * z
    return x


def infer_clip(w: W, cfg: dict, audio, shape, style, x_T, noise, cfg_scale: float, dynamic_threshold,
               prec: Prec, arch: dict):
    """A clip of 16 kHz z-scored audio, (L,) for every row or (N, L), in windows of n_motions frames:
    the features of the whole (padded) clip at once; each window sampled
    from the same x_T (N, L, 67) and z (T, N, L, 67), conditioned on the
    last n_prev frames of the previous window's motion and features; the
    padded frames of the last window masked by the indicator and cut.
    Returns (N, clip_frames, 67)."""
    n, n_prev, fps = cfg["n_motions"], cfg["n_prev_motions"], cfg["fps"]
    unit = 16000 / fps
    n_samples = audio.shape[-1]
    clip_len = int(n_samples / 16000 * fps)
    n_sub = 1 if clip_len <= n else math.ceil(clip_len / n)
    pad = round(unit * n) * n_sub - n_samples
    pad_frames = math.ceil(pad / unit)
    if pad > 0:
        audio = F.pad(audio, (0, pad))
    N = x_T.shape[0]
    feat = audio_features(w, audio.reshape(-1, audio.shape[-1]).float(), n * n_sub, fps, arch, prec)
    feat = feat.expand(N, -1, -1)
    prev_m = w["start_motion_feat"].expand(N, -1, -1)
    prev_a = w["start_audio_feat"].expand(N, -1, -1)
    shape = shape.float().reshape(N, 1, -1)
    style = style.float().reshape(N, 1, -1)
    out = []
    for i in range(n_sub):
        ind = torch.ones(N, n, device=x_T.device)
        if i == n_sub - 1 and pad_frames > 0:
            ind[:, -pad_frames:] = 0
        a = feat[:, i * n:(i + 1) * n]
        m = sample_window(w, cfg, a, shape, style, prev_m, prev_a, x_T, noise, ind, cfg_scale, dynamic_threshold,
                          prec)
        prev_m, prev_a = m[:, -n_prev:], a[:, -n_prev:]
        out.append(m[:, :-pad_frames] if (i == n_sub - 1 and pad_frames > 0) else m)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# FLAME
# ---------------------------------------------------------------------------

def rodrigues(r):
    """Axis-angle (N, 3) -> rotations (N, 3, 3), angle = |r + 1e-8|."""
    angle = torch.linalg.norm(r + 1e-8, dim=-1, keepdim=True)
    d = r / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(-1, 3, 3)
    return torch.eye(3, device=r.device) + sin * K + (1 - cos) * (K @ K)


def flame(fl: dict, shape, exp, pose6, prec: Prec):
    """FLAME's vertices (N, V, 3) from shape (N, 100), expression (N, 50)
    and pose (N, 6) = [global rotation, jaw], the neck and eyes at rest:
    blend shapes, the joints regressed from the shaped mesh, pose
    correctives, the kinematic chain, linear blend skinning."""
    N = shape.shape[0]
    betas = torch.cat([shape, exp], dim=1).float()
    sd = fl["shapedirs"]  # (V, 3, S)
    with prec.ctx():
        v_shaped = fl["v_template"][None] + prec.einsum("bl,mkl->bmk", betas, sd)
        J = prec.einsum("bik,ji->bjk", v_shaped, fl["J_regressor"])
    z3 = torch.zeros(N, 3, device=shape.device)
    full = torch.cat([pose6[:, :3], z3, pose6[:, 3:], z3, z3], dim=1).float()
    R = rodrigues(full.reshape(-1, 3)).reshape(N, -1, 3, 3)
    pose_feat = (R[:, 1:] - torch.eye(3, device=R.device)).reshape(N, -1)
    with prec.ctx():
        v_posed = v_shaped + prec.einsum("bp,pq->bq", pose_feat, fl["posedirs"]).reshape(N, -1, 3)
    parents = fl["parents"]
    rel = torch.cat([J[:, :1], J[:, 1:] - J[:, parents[1:]]], dim=1)
    top = torch.cat([R, rel[..., None]], dim=-1)  # (N, J, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=J.device).expand(N, len(parents), 1, 4)
    Tm = torch.cat([top, bottom], dim=-2)
    chain = [Tm[:, 0]]
    for j in range(1, len(parents)):
        chain.append(chain[parents[j]] @ Tm[:, j])
    G = torch.stack(chain, dim=1)
    Rg = G[:, :, :3, :3]
    tg = G[:, :, :3, 3] - torch.einsum("bjmn,bjn->bjm", Rg, J)
    Rv = torch.einsum("vj,bjmn->bvmn", fl["lbs_weights"], Rg)
    tv = torch.einsum("vj,bjm->bvm", fl["lbs_weights"], tg)
    return torch.einsum("bvmn,bvn->bvm", Rv, v_posed) + tv


def motion_to_vertices(fl: dict, motion, prec: Prec):
    """Frames of motion (N, 67) as the benchmark decodes them: the first
    50 expression channels, the head rotation as FLAME's global rotation,
    zero shape and jaw."""
    m = motion.float()
    pose6 = torch.cat([m[:, -3:], torch.zeros_like(m[:, :3])], dim=1)
    return flame(fl, torch.zeros(m.shape[0], 100, device=m.device), m[:, :50], pose6, prec)


def stream_clip(w: W, cfg: dict, audio, shape, style, x_T, noises, prec: Prec, arch: dict, cfg_scale: float,
                dynamic_threshold=None):
    """Streams of whole windows (N, n_windows * window samples) as a
    streaming server serves them: each window's audio features taken from
    that window alone, window 0 from x_T (N, L, 67), window k with the z
    of ``noises[k]`` (T, N, L, 67), the same x_T throughout, the previous
    window's last n_prev frames of motion and features carried. Returns
    (N, n_windows * L, 67)."""
    n, n_prev, fps = cfg["n_motions"], cfg["n_prev_motions"], cfg["fps"]
    ns = round(16000 / fps * n)
    N = x_T.shape[0]
    prev_m = w["start_motion_feat"].expand(N, -1, -1)
    prev_a = w["start_audio_feat"].expand(N, -1, -1)
    shape = shape.float().reshape(N, 1, -1)
    style = style.float().reshape(N, 1, -1)
    ind = torch.ones(N, n, device=x_T.device)
    out = []
    for k, z in enumerate(noises):
        a = audio_features(w, audio[:, k * ns:(k + 1) * ns].float(), n, fps, arch, prec)
        m = sample_window(w, cfg, a, shape, style, prev_m, prev_a, x_T, z, ind, cfg_scale, dynamic_threshold, prec)
        prev_m, prev_a = m[:, -n_prev:], a[:, -n_prev:]
        out.append(m)
    return torch.cat(out, dim=1)
