"""A plain PyTorch reference of MSMD's vertex-space two-clip training step
(DiffPoseTalk's recipe as MSMD's training script runs it on the HDTF /
FLAME layout, both clips of a batch in one forward), independent of the
program: it imports nothing of the port or of the JAX package.

It makes every random draw that the step makes, in the same order, from
generators seeded alike: on the device, each dropout's keep draw
(``rand >= p``; the identity band's per-head keep of the gathered memory
row, ``rand < 1 - p``), SpecAugment's span starts, the guidance drop, the
timesteps, the noise, the style's reparameterisation and each FFN
block's mask seed; on the host, each clip's cross-style flag, truncation
ends and truncation flag. The FFN blocks' masks are Philox4x32-10 bits
(Salmon et al., SC 2011) keyed by (seed, salt), counter (col / 4, row, 0,
0), kept where the bits are at least p 2^32: salt 1 for the hidden state,
2 for the block's output. The step's mathematics is the published one;
the rounding is float32 with TF32 off (or the control's ``Prec``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from h100bench.reference import model as m
from h100bench.reference.precision import Prec

P = 0.1  # the dropout of the denoiser, the audio encoder and the style encoder's layer
M32 = 0xFFFFFFFF


def rand(shape, g: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)


def dropout(x, p: float, g: torch.Generator):
    keep = rand(x.shape, g).to(x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------

def _mulhilo(a: torch.Tensor, b: int):
    """(high, low) 32-bit words of a * b, a < 2^32 in int64, b a 32-bit constant."""
    lo16, hi16 = b & 0xFFFF, b >> 16
    x, y = a * lo16, a * hi16  # below 2^48 each
    low_sum = x + ((y & 0xFFFF) << 16)
    return (y >> 16) + (low_sum >> 32), low_sum & M32


def philox_words(key0, key1: int, c0, c1, c2, c3):
    k0, k1 = key0, key1
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        h0, l0 = _mulhilo(c0, 0xD2511F53)
        h1, l1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def philox_keep(seed: torch.Tensor, salt: int, rows: int, cols: int, p: float) -> torch.Tensor:
    """Inverted-dropout multipliers (rows, cols) of an FFN block's mask."""
    dev = seed.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None].expand(rows, cols // 4)
    c = torch.arange(cols // 4, dtype=torch.int64, device=dev)[None, :].expand(rows, cols // 4)
    z = torch.zeros_like(r)
    words = philox_words(seed.reshape(()).to(torch.int64) & M32, salt, c, r, z, z)
    bits = torch.stack(words, dim=-1).reshape(rows, cols)
    return (bits >= int(p * 2.0 ** 32)).float() / (1.0 - p)


# ---------------------------------------------------------------------------
# the modules in training mode
# ---------------------------------------------------------------------------

def self_attention(w, p: str, x, heads: int, g, prec: Prec):
    """Self-attention before the output projection, with dropout on the
    attention weights."""
    B, L, Fd = x.shape
    dh = Fd // heads
    q, k, v = (m.dense(w, p + n, x, prec).reshape(B, L, heads, dh) for n in ("q_proj", "k_proj", "v_proj"))
    a = dropout(torch.softmax(prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh), dim=-1), P, g)
    return prec.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, L, Fd)


def style_train(w, clip, g, prec: Prec, heads: int = 8):
    """The VAE2 encoder with its dropout (0.2 in the conv stem, 0.1 after
    the positional row, in the encoder layer and the head), then one
    reparameterised draw. Returns (z, mu, logvar)."""
    x = clip.float()
    conv = lambda p, t: prec.conv1d(t.transpose(1, 2), w[p + ".weight"], w[p + ".bias"], padding=1).transpose(1, 2)
    for i in range(2):
        x = m.layer_norm(w, f"input_layers.norm.{i}", F.elu(dropout(conv(f"input_layers.conv.{i}", x), 0.2, g)))
    x = dropout(x + m.sinusoid(x.shape[-1], 600, x.device)[x.shape[1]], P, g)
    a = self_attention(w, "encoder.self_attn.", x, heads, g, prec)
    x = m.layer_norm(w, "encoder.norm1", x + dropout(m.dense(w, "encoder.self_attn.out_proj", a, prec), P, g))
    f = m.dense(w, "encoder.ffn.linear2", dropout(m.gelu(m.dense(w, "encoder.ffn.linear1", x, prec)), P, g), prec)
    x = m.layer_norm(w, "encoder.norm2", x + dropout(f, P, g))
    x = m.layer_norm(w, "out_norm", F.elu(dropout(conv("out_conv.0", x), P, g)))
    out = conv("out_conv.1", x).mean(dim=1)
    d = out.shape[1] // 2
    mu, logvar = out[:, :d], out[:, d:]
    eps = torch.randn(mu.shape, generator=g, device=g.device)
    return mu + eps * torch.exp(0.5 * logvar), mu, logvar


def audio_train(w, audio, frame_num: int, fps: int, arch: dict, g, prec: Prec):
    """HuBERT in training mode (dropout 0.1 after the projection, the
    positional sum and in every layer; SpecAugment's time masks) at twice
    the frames, resampled and projected: (N, frame_num, feature_dim)."""
    p = "audio_encoder."
    x = m.pad_audio(audio.float())[:, None]
    for i, s in enumerate(arch["conv_stride"]):
        x = prec.conv1d(x, w[f"{p}feature_extractor.conv.{i}.weight"], stride=s)
        if i == 0:
            mu = x.mean(dim=2, keepdim=True)
            var = ((x - mu) ** 2).mean(dim=2, keepdim=True)
            gn = p + "feature_extractor.group_norm"
            x = (x - mu) * torch.rsqrt(var + m.LN_EPS) * w[gn + ".weight"][:, None] + w[gn + ".bias"][:, None]
        x = m.gelu(x)
    T2 = 2 * frame_num
    h = m.resample(x.transpose(1, 2)[:, :round(T2 * 50 / fps)], T2)
    h = dropout(m.dense(w, p + "feature_projection.projection",
                        m.layer_norm(w, p + "feature_projection.layer_norm", h), prec), P, g)
    N, L = h.shape[:2]
    span = arch["mask_time_length"]
    n_spans = max(2, int(arch["mask_time_prob"] * L / float(span) + 0.5))
    starts = torch.randint(0, max(1, L - span), (N, n_spans), generator=g, device=g.device)
    pos = torch.arange(L, device=g.device)[None, None, :]
    masked = ((pos >= starts[..., None]) & (pos < starts[..., None] + span)).any(dim=1).to(h.device)
    h = torch.where(masked[..., None], w[p + "masked_spec_embed"], h)
    k = arch["num_conv_pos_embeddings"]
    pc = prec.conv1d(h.transpose(1, 2), w[p + "encoder.pos_conv_embed.conv.weight"],
                     w[p + "encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                     groups=arch["num_conv_pos_embedding_groups"]).transpose(1, 2)
    if k % 2 == 0:
        pc = pc[:, :-1]
    x = dropout(m.layer_norm(w, p + "encoder.layer_norm", h + m.gelu(pc)), P, g)
    for i in range(arch["num_layers"]):
        lp = f"{p}encoder.layers.{i}."
        a = m.attention(w, lp + "q_proj", lp + "k_proj", lp + "v_proj", x, x, arch["num_heads"], None, prec)
        x = m.layer_norm(w, lp + "layer_norm", x + dropout(m.dense(w, lp + "out_proj", a, prec), P, g))
        f = m.dense(w, lp + "output_dense", dropout(m.gelu(m.dense(w, lp + "intermediate_dense", x, prec)), P, g),
                    prec)
        x = m.layer_norm(w, lp + "final_layer_norm", x + dropout(f, P, g))
    return m.dense(w, "audio_feature_map", m.resample(x, frame_num), prec)


def ffn_block(w, lp: str, x, g, prec: Prec):
    """LN(x + drop2(W2 drop1(gelu(W1 x + b1)) + b2)) with Philox masks
    from a seed drawn for the block."""
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device=g.device, dtype=torch.int32)
    B, L, Fd = x.shape
    h = m.gelu(m.dense(w, lp + "ffn.linear1", x, prec)).reshape(B * L, -1)
    h = h * philox_keep(seed, 1, B * L, h.shape[1], P).to(h.device)
    y = m.dense(w, lp + "ffn.linear2", h, prec)
    y = y * philox_keep(seed, 2, B * L, Fd, P).to(y.device)
    return m.layer_norm(w, lp + "norm3", x + y.reshape(B, L, Fd))


def denoise_train(w, cfg: dict, motion, audio_feat, person, style, prev_motion, prev_audio, t, indicator, g,
                  prec: Prec):
    """The denoiser in training mode under the width-1 band: dropout on
    the self-attention weights and after each sublayer; the person token's
    cross-attention with dropout on its weights, each motion token's
    memory row kept per head; the FFN blocks' Philox masks."""
    p = "denoising_net."
    N, L = motion.shape[:2]
    Lp = prev_motion.shape[1]
    Fd, T, H = cfg["feature_dim"], cfg["n_diff_steps"], cfg["n_heads"]
    dh = Fd // H
    emb = m.sinusoid(Fd, T + 1, motion.device)[t]
    emb = m.dense(w, p + "diff_step_map.linear2", m.gelu(m.dense(w, p + "diff_step_map.linear1", emb, prec)), prec)
    tok_p = m.dense(w, p + "person_proj", person, prec) + emb[:, None]
    ind = torch.cat([torch.zeros(N, Lp, device=motion.device), indicator.float()], dim=1)[..., None]
    feats = torch.cat([prev_motion.float(), motion.float()], dim=1)
    x = torch.cat([tok_p, m.dense(w, p + "feature_proj", torch.cat([feats, ind], dim=-1), prec)], dim=1)
    x = x + w[p + "PE"]
    memory = torch.cat([prev_audio.float(), audio_feat.float()], dim=1)
    Lm = memory.shape[1]
    for i in range(cfg["n_layers"]):
        lp = f"{p}transformer.layers.{i}."
        sa, ca = lp + "self_attn.", lp + "cross_attn."
        a = self_attention(w, sa, x, H, g, prec)
        x = m.layer_norm(w, lp + "norm1", x + dropout(m.dense(w, sa + "out_proj", a, prec), P, g))
        kh = m.dense(w, ca + "k_proj", memory, prec).reshape(N, Lm, H, dh)
        vh = m.dense(w, ca + "v_proj", memory, prec).reshape(N, Lm, H, dh)
        q0 = m.dense(w, ca + "q_proj", x[:, :1], prec).reshape(N, 1, H, dh)
        att = torch.softmax(prec.einsum("bqhd,bkhd->bhqk", q0, kh) / math.sqrt(dh), dim=-1)
        person_out = prec.einsum("bhqk,bkhd->bqhd", dropout(att, P, g), vh)
        keep = (rand((N, Lm, H, 1), g) < 1.0 - P).to(vh.device)
        rows = torch.cat([person_out, vh * keep / (1.0 - P)], dim=1).reshape(N, Lm + 1, Fd)
        x = m.layer_norm(w, lp + "norm2", x + dropout(m.dense(w, ca + "out_proj", rows, prec), P, g))
        x = ffn_block(w, lp, x, g, prec)
    dec = m.dense(w, p + "motion_dec_2", m.gelu(m.dense(w, p + "motion_dec_1", x[:, 1:], prec)), prec)
    K = cfg["num_of_basis"]
    dynamic, alphas = dec[..., :-K], dec[..., -K:]
    static = torch.stack([m.dense(w, f"{p}static_feature_mapping.{k}.linear2",
                                  m.gelu(m.dense(w, f"{p}static_feature_mapping.{k}.linear1", style, prec)), prec)
                          for k in range(K)], dim=2)
    face = (static[..., :-3] * alphas[..., None]).sum(dim=2)
    pose = static[..., -3:].sum(dim=2).expand(N, dec.shape[1], 3)
    return dynamic + torch.cat([face, pose], dim=-1)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def masked_mean(x, mask):
    mk = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).to(x.dtype)
    per_row = math.prod(x.shape[mask.ndim:])
    return (x * mk).sum() / torch.clamp(mask.to(x.dtype).sum() * per_row, min=1.0)


def vertices(fl: dict, coef, shape, stats: dict, prec: Prec):
    """Frames of HDTF-layout motion (B, S, 67) -> FLAME vertices (B, S, V, 3):
    expression channels 0-49 and the jaw's rotation about x (the last
    channel) denormalised by the statistics, the shape at its mean."""
    B, S = coef.shape[:2]
    exp = coef[..., :50] * stats["exp_std"] + stats["exp_mean"]
    z = torch.zeros_like(coef[..., :1])
    pose = torch.cat([z, z, z, coef[..., -1:], z, z], dim=-1) * stats["pose_std"] + stats["pose_mean"]
    pose = torch.cat([torch.zeros_like(pose[..., :3]), pose[..., 3:]], dim=-1)
    shape = (shape[:, None].expand(B, S, -1) * stats["shape_std"] + stats["shape_mean"])
    v = m.flame(fl, shape.reshape(-1, 100), exp.reshape(-1, 50), pose.reshape(-1, 6), prec)
    return v.reshape(B, S, -1, 3)


def clip_loss(cfg: dict, first: bool, shape, gt, target, prev_motion, end_idx, stats, fl, prec: Prec) -> Dict:
    """One clip's terms: the sample target in coefficient space, vertex
    position, velocity and smoothness, and head angle, velocity, smoothness
    and (for the later clip) the window-boundary transition."""
    n, n_prev = cfg["n_motions"], cfg["n_prev_motions"]
    B = gt.shape[0]
    sq = lambda a, b: (a - b) ** 2
    diff = lambda t: t[:, 1:] - t[:, :-1]
    mask = torch.arange(n, device=gt.device)[None, :] < end_idx[:, None]
    if first:
        target = target[:, n_prev:]
    else:
        gt = torch.cat([prev_motion, gt], dim=1)
        mask = torch.cat([torch.ones(B, n_prev, dtype=torch.bool, device=gt.device), mask], dim=1)
    out = {"noise": masked_mean(sq(gt, target), mask) / 2}
    vg, vp = vertices(fl, gt, shape, stats, prec), vertices(fl, target, shape, stats, prec)
    out["vert"] = masked_mean(sq(vg, vp), mask) / 2
    out["vel"] = masked_mean(sq(diff(vg), diff(vp)), mask[:, 1:]) / 2
    velp = diff(vp)
    out["smooth"] = masked_mean(sq(velp[:, 1:], velp[:, :-1]), mask[:, 2:]) / 2
    hg, hp = gt[..., 50:53], target[..., 50:53]
    out["head_angle"] = masked_mean(sq(hg, hp), mask) / 2
    out["head_vel"] = masked_mean(sq(diff(hg), diff(hp)), mask[:, 1:]) / 2
    hv = diff(hp)
    out["head_smooth"] = masked_mean(sq(hv[:, 1:], hv[:, :-1]), mask[:, 2:]) / 2
    if not first:
        tr = torch.cat([hg[:, n_prev - 3:n_prev], hp[:, n_prev:n_prev + 3]], dim=1)
        vel = diff(tr)
        acc = diff(vel)
        out["head_trans"] = (masked_mean(sq(vel[:, 2:4], vel[:, 1:3]), mask[:, n_prev:n_prev + 2])
                             + masked_mean(sq(acc[:, 1:], acc[:, :-1]), mask[:, n_prev:n_prev + 3]))
    return out


def two_clip_loss(w: dict, ws: dict, fl: dict, stats: dict, cfg: dict, arch: dict, batch: dict,
                  g: torch.Generator, hg: torch.Generator, prec: Prec, prec_flame: Prec):
    """The step's loss: both clips' styles, audio and denoiser in one
    forward, clip 1 carrying clip 0's last frames (the uncut ones) and their
    audio features; the weighted sum of both clips' terms and the style's
    KL divergence."""
    n, n_prev, fps = cfg["n_motions"], cfg["n_prev_motions"], cfg["fps"]
    B = batch["motion_0"].shape[0]
    motion_cat = torch.cat([batch["motion_0"], batch["motion_1"]])
    z, mu, logvar = style_train(ws, motion_cat, g, prec)
    styles = [z[:B], z[B:]]
    shape = batch["shape_0"][:, 0]
    clips = []
    for i in range(2):
        audio, motion = batch[f"audio_{i}"], batch[f"motion_{i}"]
        style = styles[i]
        if float(torch.rand((), generator=hg)) < cfg["prob_cross_style"]:
            style = styles[1 - i]
        ends = torch.randint(1, n, (B,), generator=hg)
        cut = float(torch.rand((), generator=hg)) < (cfg["trunc_prob1"] if i == 0 else cfg["trunc_prob2"])
        if cut:
            end = ends.to(motion.device)
            keep_a = torch.arange(audio.shape[1], device=audio.device)[None] < (end.float() * 640.0).long()[:, None]
            keep_m = torch.arange(n, device=motion.device)[None] < end[:, None]
            audio, motion = audio * keep_a, motion * keep_m[..., None]
        else:
            end = torch.full((B,), n, dtype=torch.int64, device=motion.device)
        clips.append((style, audio, motion, end, cut))
    feat = audio_train(w, torch.cat([c[1] for c in clips]), n, fps, arch, g, prec)
    prev_motion = batch["motion_0"][:, -n_prev:]
    full = feat[:B].detach()
    if clips[0][4]:
        with torch.no_grad():
            full = m.audio_features(w, batch["audio_0"], n, fps, arch, prec)
    prev_m = torch.cat([w["start_motion_feat"].expand(B, -1, -1), prev_motion])
    prev_a = torch.cat([w["start_audio_feat"].expand(B, -1, -1), full[:, -n_prev:]])
    N = 2 * B
    style_in = torch.cat([c[0] for c in clips])[:, None]
    audio_in = feat
    flag = rand((N,), g)[:, None, None]
    style_in = torch.where(flag > 0.55, w["null_style_feat"], style_in)
    audio_in = torch.where(flag > 0.9, w["null_audio_feat"], audio_in)
    person = torch.cat([torch.cat([shape, shape])[:, None], style_in], dim=-1)
    t = torch.randint(1, cfg["n_diff_steps"] + 1, (N,), generator=g, device=g.device)
    ab = torch.as_tensor(m.cosine_schedule(cfg["n_diff_steps"])[1], device=feat.device)[t]
    noise = torch.randn((N, n, 67), generator=g, device=g.device)
    x0 = torch.cat([c[2] for c in clips])
    x_t = torch.sqrt(ab)[:, None, None] * x0 + torch.sqrt(1.0 - ab)[:, None, None] * noise
    ind = (torch.arange(n, device=x0.device)[None] < torch.cat([c[3] for c in clips])[:, None]).float()
    target = denoise_train(w, cfg, x_t, audio_in, person, style_in, prev_m, prev_a, t, ind, g, prec)
    weights = dict(noise=1.0, vert=cfg["l_vert"], vel=cfg["l_vel"], smooth=cfg["l_smooth"],
                   head_angle=cfg["l_head_angle"], head_vel=cfg["l_head_vel"], head_smooth=cfg["l_head_smooth"],
                   head_trans=cfg["l_head_trans"])
    total = 0.0
    for i in range(2):
        terms = clip_loss(cfg, i == 0, shape, clips[i][2], target[i * B:(i + 1) * B].float(), prev_motion,
                          clips[i][3], stats, fl, prec_flame)
        total = total + sum(weights[k] * v for k, v in terms.items())
        mu_i, lv_i = mu[i * B:(i + 1) * B], logvar[i * B:(i + 1) * B]
        total = total + cfg["l_kl_div"] * (-0.5 * torch.sum(1 + lv_i - mu_i ** 2 - torch.exp(lv_i)))
    return total


def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update of the leaves that have a gradient."""
    state["step"] = state.get("step", 0) + 1
    k = state["step"]
    for name, gr in grads.items():
        mo, ve = state.setdefault(name, (torch.zeros_like(gr), torch.zeros_like(gr)))
        mo.mul_(b1).add_(gr, alpha=1 - b1)
        ve.mul_(b2).addcmul_(gr, gr, value=1 - b2)
        denom = (ve.sqrt() / math.sqrt(1 - b2 ** k)).add_(eps)
        params[name].data.addcdiv_(mo, denom, value=-lr / (1 - b1 ** k))


def train_steps(w: dict, ws: dict, trainable: List[str], fl: dict, stats: dict, cfg: dict, arch: dict,
                batches: List[dict], g: torch.Generator, hg: torch.Generator, prec: Prec, prec_flame: Prec,
                lr: float):
    """Steps of the two-clip loss and Adam from the weights ``w`` (the
    denoiser, audio encoder and the rest) and ``ws`` (the style encoder),
    one a batch. Returns (losses, the first step's gradients, the weights
    after the last step); the frozen leaves take no gradient."""
    params = {("m." + k): v.detach().clone().float() for k, v in w.items()}
    params.update({("s." + k): v.detach().clone().float() for k, v in ws.items()})
    train = set(trainable)
    for k, v in params.items():
        v.requires_grad_(k in train)
    state: Dict = {}
    losses, first = [], None
    for batch in batches:
        wm = {k[2:]: v for k, v in params.items() if k.startswith("m.")}
        wsd = {k[2:]: v for k, v in params.items() if k.startswith("s.")}
        loss = two_clip_loss(wm, wsd, fl, stats, cfg, arch, batch, g, hg, prec, prec_flame)
        names = [k for k in params if k in train]
        gr = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: v for k, v in zip(names, gr) if v is not None}
        if first is None:
            first = {k: v.detach().clone() for k, v in grads.items()}
        with torch.no_grad():
            adam(params, grads, state, lr)
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}
