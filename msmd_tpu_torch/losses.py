"""The MSMD loss suite (the port of ``msmd_tpu/losses.py``; reference:
utils/common.py:117-620, 769-832, training_script.py:406-438): the
parameter-space ``compute_loss_no_vert`` and the vertex-space
``compute_loss``, which decodes FLAME vertices through the fused decode
(``ops/kernels/lbs.py::flame_vertices``: K5 and its backward K5 bwd on the
card) for a ``FusedFlame``, or through ``flame_forward`` for a
``FlameModel``.

The reference's quirks are kept: every term is halved except head_trans
(the loop sums two clips); masked means are means over the selected
elements; the velocity and smoothness masks are the base mask shifted by
1 and 2 frames; the param-space variant takes head pose as the last 3
channels and an unmasked head-transition term, the vertex-space variant
head pose at channels 50:53 (the 50-exp HDTF / FLAME layout) and a
head-transition term masked by the current window's first frames. The
espnet variant ``compute_loss_espnet`` takes precomputed vertices and
unmasked vertex means, head pose at the last 3 channels. The auxiliary
``style_adherence_loss`` and ``nt_xent_loss`` are library features that
the reference defines but does not wire into its training loop, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from msmd_tpu_torch.config import is_hdtf

LOSS_KEYS = ("noise", "vert", "vel", "smooth", "head_angle", "head_vel", "head_smooth", "head_trans")


def _criterion(name: str):
    if name.lower() == "l2":
        return lambda a, b: (a - b) ** 2
    if name.lower() == "l1":
        return lambda a, b: (a - b).abs()
    raise NotImplementedError(f"Criterion {name} not implemented.")


class ShareMask:
    """A rank's row mask (``local``) beside the same mask over the global
    batch (``whole``) of which the rank holds an equal share of the rows
    (data parallelism). Slicing slices both."""

    def __init__(self, local: torch.Tensor, whole: torch.Tensor):
        self.local, self.whole = local, whole

    def __getitem__(self, idx) -> "ShareMask":
        return ShareMask(self.local[idx], self.whole[idx])


def _masked_mean(x: torch.Tensor, mask) -> torch.Tensor:
    """Mean of x over the rows that ``mask`` selects (torch's
    ``x[mask].mean()``, broadcast over x's trailing dims); 0 for an empty
    mask. For a ``ShareMask`` the sum over the rank's rows is divided by
    the rank's share of the global batch's count (the global count times
    local rows / global rows), so the mean over the ranks of their values
    is the global batch's masked mean."""
    whole = None
    if isinstance(mask, ShareMask):
        mask, whole = mask.local, mask.whole
    extra = x.ndim - mask.ndim
    m = mask.reshape(mask.shape + (1,) * extra).to(x.dtype)
    per_row = 1
    for n in x.shape[mask.ndim:]:
        per_row *= n
    count = mask.to(x.dtype).sum() if whole is None else whole.to(x.dtype).sum() * (mask.shape[0] / whole.shape[0])
    return (x * m).sum() / torch.clamp(count * per_row, min=1.0)


def compute_kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Sum-reduced KL(q || N(0, 1)) (reference: utils/common.py:443-454)."""
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))


def _base_mask(cfg, batch_size: int, end_idx: Optional[torch.Tensor], is_starting_sample: bool, device,
               end_idx_all: Optional[torch.Tensor] = None):
    """The loss mask of the window's frames (of the previous window's too
    for a later clip's ``sample`` target); with ``end_idx_all`` (the global
    batch's ends, of which ``end_idx`` is a rank's equal share) a
    ``ShareMask``."""
    if end_idx_all is not None:
        return ShareMask(_base_mask(cfg, batch_size, end_idx, is_starting_sample, device),
                         _base_mask(cfg, len(end_idx_all), end_idx_all, is_starting_sample, device))
    if end_idx is None:
        mask = torch.ones(batch_size, cfg.n_motions, dtype=torch.bool, device=device)
    else:
        mask = torch.arange(cfg.n_motions, device=device)[None, :] < end_idx.to(device)[:, None]
    if cfg.target == "sample" and not is_starting_sample:
        fill = torch.zeros if cfg.no_constrain_prev else torch.ones
        mask = torch.cat([fill(batch_size, cfg.n_prev_motions, dtype=torch.bool, device=device), mask], dim=1)
    return mask


def _head_trans_loss(crit, head_pose_gt, head_pose_pred, n_prev: int, mask=None) -> torch.Tensor:
    """Window-boundary continuity of the head pose: velocities of
    [gt[-3:], pred[:3]] at frames [2:4] vs [1:3], accelerations
    consecutive-matched. Without ``mask`` the param-space reference's
    unmasked means (utils/common.py:352-368, 417); with it the vertex-space
    reference's means over the current window's first 2 and 3 frames
    (utils/common.py:585-590)."""
    if n_prev < 3:
        raise ValueError("head_trans loss requires n_prev_motions >= 3")
    trans = torch.cat([head_pose_gt[:, n_prev - 3:n_prev], head_pose_pred[:, n_prev:n_prev + 3]], dim=1)
    vel = trans[:, 1:] - trans[:, :-1]
    accel = vel[:, 1:] - vel[:, :-1]
    l_vel, l_accel = crit(vel[:, 2:4], vel[:, 1:3]), crit(accel[:, 1:], accel[:, :-1])
    if mask is None:
        return l_vel.mean() + l_accel.mean()
    return _masked_mean(l_vel, mask[:, n_prev:n_prev + 2]) + _masked_mean(l_accel, mask[:, n_prev:n_prev + 3])


def compute_loss_no_vert(cfg, is_starting_sample: bool, shape_coef, motion_coef_gt: torch.Tensor,
                         noise: torch.Tensor, target: torch.Tensor, prev_motion_coef: Optional[torch.Tensor],
                         end_idx: Optional[torch.Tensor] = None,
                         end_idx_all: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Parameter-space losses (``msmd_tpu/losses.py``:112-181; reference:
    utils/common.py:198-441). Returns a dict over LOSS_KEYS; absent terms
    are 0. ``end_idx_all``: the global batch's ends when the rows are a
    rank's share of it (the masked means then take the global count;
    ``_masked_mean``)."""
    crit = _criterion(cfg.criterion)
    B, dev = motion_coef_gt.shape[0], target.device
    zero = torch.zeros((), dtype=target.dtype, device=dev)
    out = {k: zero for k in LOSS_KEYS}

    if cfg.target == "noise":
        mask = _base_mask(cfg, B, end_idx, True, dev, end_idx_all)
        out["noise"] = _masked_mean(crit(noise, target[:, cfg.n_prev_motions:]), mask) / 2
        return out
    if cfg.target != "sample":
        raise ValueError(f"Unknown diffusion target: {cfg.target}")

    if is_starting_sample:
        target = target[:, cfg.n_prev_motions:]
    else:
        motion_coef_gt = torch.cat([prev_motion_coef, motion_coef_gt], dim=1)
        if cfg.no_constrain_prev:
            target = torch.cat([prev_motion_coef, target[:, cfg.n_prev_motions:]], dim=1)

    mask = _base_mask(cfg, B, end_idx, is_starting_sample, dev, end_idx_all)
    out["noise"] = _masked_mean(crit(motion_coef_gt, target), mask) / 2

    exp_gt, pose_gt = motion_coef_gt[..., :-3], motion_coef_gt[..., -3:]
    exp_pred, pose_pred = target[..., :-3], target[..., -3:]
    diff = lambda t: t[:, 1:] - t[:, :-1]

    if cfg.l_vel > 0 or cfg.l_smooth > 0:
        vel_pred_exp, vel_pred_pose = diff(exp_pred), diff(pose_pred)
        if cfg.l_vel > 0:
            loss_vel = crit(diff(exp_gt), vel_pred_exp).mean(-1) + crit(diff(pose_gt), vel_pred_pose).mean(-1)
            out["vel"] = _masked_mean(loss_vel, mask[:, 1:]) / 2
        if cfg.l_smooth > 0:
            sm_exp, sm_pose = diff(vel_pred_exp), diff(vel_pred_pose)
            loss_smooth = (crit(sm_exp, torch.zeros_like(sm_exp)).mean(-1)
                           + crit(sm_pose, torch.zeros_like(sm_pose)).mean(-1))
            out["smooth"] = _masked_mean(loss_smooth, mask[:, 2:]) / 2

    if not cfg.no_head_pose:
        out["head_angle"] = _masked_mean(crit(pose_gt, pose_pred), mask) / 2
        if cfg.l_head_vel > 0:
            out["head_vel"] = _masked_mean(crit(diff(pose_gt), diff(pose_pred)).mean(-1), mask[:, 1:]) / 2
        if cfg.l_head_smooth > 0:
            hvp = diff(pose_pred)
            hs = crit(diff(hvp), torch.zeros_like(hvp[:, 1:])).mean(-1)
            out["head_smooth"] = _masked_mean(hs, mask[:, 2:]) / 2
        if not is_starting_sample and cfg.l_head_trans > 0:
            # not halved (reference: utils/common.py:435)
            out["head_trans"] = _head_trans_loss(crit, pose_gt, pose_pred, cfg.n_prev_motions)
    return out


# ---------------------------------------------------------------------------
# coefficient <-> dict helpers (reference: utils/common.py:117-196)
# ---------------------------------------------------------------------------

def get_pose_input(coef_dict, rot_repr: str, with_global_pose: bool) -> torch.Tensor:
    if rot_repr != "aa":
        raise ValueError(f"Unknown rotation representation: {rot_repr}")
    pose = coef_dict["pose"] if with_global_pose else coef_dict["pose"][..., -3:]
    return pose[..., :-2]  # drop the mouth's rotation about y and z


def _stat(stats, key: str, like: torch.Tensor) -> torch.Tensor:
    v = stats[key]
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def get_motion_coef(coef_dict, rot_repr: str, with_global_pose: bool = False, norm_stats=None) -> torch.Tensor:
    if norm_stats is not None:
        if rot_repr != "aa":
            raise ValueError(f"Unknown rotation representation {rot_repr}!")
        coef_dict = {k: (coef_dict[k] - _stat(norm_stats, f"{k}_mean", coef_dict[k]))
                     / _stat(norm_stats, f"{k}_std", coef_dict[k]) for k in ("exp", "pose")}
    return torch.cat([coef_dict["exp"], get_pose_input(coef_dict, rot_repr, with_global_pose)], dim=-1)


def get_coef_dict(motion_coef: torch.Tensor, shape_coef: Optional[torch.Tensor] = None, denorm_stats=None,
                  with_global_pose: bool = False, rot_repr: str = "aa") -> Dict[str, torch.Tensor]:
    """Split an HDTF-layout motion coefficient into {exp (50), pose (6)}
    (+ shape, broadcast over the frames), denormalised by ``denorm_stats``
    (reference: utils/common.py:140-173)."""
    if rot_repr != "aa":
        raise ValueError(f"Unknown rotation representation {rot_repr}!")
    coef_dict = {"exp": motion_coef[..., :50]}
    if with_global_pose:
        pose = motion_coef[..., 50:]
    else:
        pose = torch.cat([torch.zeros_like(motion_coef[..., :3]), motion_coef[..., -1:]], dim=-1)
    coef_dict["pose"] = torch.cat([pose, torch.zeros_like(motion_coef[..., :2])], dim=-1)
    if shape_coef is not None:
        if motion_coef.ndim == 3:
            if shape_coef.ndim == 2:
                shape_coef = shape_coef[:, None]
            if shape_coef.shape[1] == 1:
                shape_coef = shape_coef.expand(shape_coef.shape[0], motion_coef.shape[1], shape_coef.shape[-1])
        coef_dict["shape"] = shape_coef
    if denorm_stats is not None:
        coef_dict = {k: v * _stat(denorm_stats, f"{k}_std", v) + _stat(denorm_stats, f"{k}_mean", v)
                     for k, v in coef_dict.items()}
    if not with_global_pose:  # the JAX package's .at[..., :3].set(0), out of place
        p = coef_dict["pose"]
        coef_dict["pose"] = torch.cat([torch.zeros_like(p[..., :3]), p[..., 3:]], dim=-1)
    return coef_dict


def _decode_vertices(flame, shape, exp, pose, ignore_global_rot: bool = False) -> torch.Tensor:
    """FLAME vertices through the fused decode for a ``FusedFlame``
    (``flame_vertices``), through ``flame_forward`` for a ``FlameModel``."""
    from msmd_tpu_torch.models.flame import flame_forward
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame, flame_vertices

    if isinstance(flame, FusedFlame):
        return flame_vertices(flame, shape, exp, pose, ignore_global_rot=ignore_global_rot)
    return flame_forward(flame, shape, exp, pose, ignore_global_rot=ignore_global_rot)[0]


def coef_dict_to_vertices(coef_dict, flame, rot_repr: str = "aa", ignore_global_rot: bool = False) -> torch.Tensor:
    """Decode a (..., 50)-exp coefficient dict to vertices (..., V, 3)
    (reference: utils/common.py:176-196) in one call, without the
    reference's chunking for GPU memory."""
    if rot_repr != "aa":
        raise ValueError(f"Unknown rot_repr: {rot_repr}")
    lead = coef_dict["exp"].shape[:-1]
    flat = {k: v.reshape(-1, v.shape[-1]) for k, v in coef_dict.items()}
    verts = _decode_vertices(flame, flat["shape"], flat["exp"], flat["pose"], ignore_global_rot)
    return verts.reshape(*lead, *verts.shape[1:])


def compute_loss(cfg, is_starting_sample: bool, shape_coef: torch.Tensor, motion_coef_gt: torch.Tensor,
                 noise: torch.Tensor, target: torch.Tensor, prev_motion_coef: Optional[torch.Tensor], coef_stats,
                 flame, end_idx: Optional[torch.Tensor] = None,
                 end_idx_all: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Vertex-space losses (``msmd_tpu/losses.py``:254-327; reference:
    utils/common.py:456-620): the noise term in coefficient space; vert,
    vel and smooth on FLAME vertices decoded from the ``coef_stats``
    denormalised coefficients; head pose at channels 50:53. ``end_idx_all``
    as in ``compute_loss_no_vert``."""
    crit = _criterion(cfg.criterion)
    B, dev = motion_coef_gt.shape[0], target.device
    zero = torch.zeros((), dtype=target.dtype, device=dev)
    out = {k: zero for k in LOSS_KEYS}

    if cfg.target == "noise":
        mask = _base_mask(cfg, B, end_idx, True, dev, end_idx_all)
        out["noise"] = _masked_mean(crit(noise, target[:, cfg.n_prev_motions:]), mask) / 2
        return out
    if cfg.target != "sample":
        raise ValueError(f"Unknown diffusion target: {cfg.target}")

    if is_starting_sample:
        target = target[:, cfg.n_prev_motions:]
    else:
        motion_coef_gt = torch.cat([prev_motion_coef, motion_coef_gt], dim=1)
        if cfg.no_constrain_prev:
            target = torch.cat([prev_motion_coef, target[:, cfg.n_prev_motions:]], dim=1)

    mask = _base_mask(cfg, B, end_idx, is_starting_sample, dev, end_idx_all)
    out["noise"] = _masked_mean(crit(motion_coef_gt, target), mask) / 2
    diff = lambda t: t[:, 1:] - t[:, :-1]

    if cfg.l_vert > 0 or cfg.l_vel > 0:
        seq_len = target.shape[1]
        verts = []
        for coef in (motion_coef_gt, target):
            d = get_coef_dict(coef, shape_coef, coef_stats, with_global_pose=False, rot_repr=cfg.rot_repr)
            v = _decode_vertices(flame, d["shape"].reshape(-1, 100), d["exp"].reshape(-1, 50),
                                 d["pose"].reshape(-1, 6))
            verts.append(v.reshape(-1, seq_len, v.shape[-2], 3))
        verts_gt, verts_pred = verts
        if cfg.l_vert > 0:
            out["vert"] = _masked_mean(crit(verts_gt, verts_pred), mask) / 2
        if cfg.l_vel > 0:
            out["vel"] = _masked_mean(crit(diff(verts_gt), diff(verts_pred)), mask[:, 1:]) / 2
        if cfg.l_smooth > 0:
            vel_pred = diff(verts_pred)
            out["smooth"] = _masked_mean(crit(vel_pred[:, 1:], vel_pred[:, :-1]), mask[:, 2:]) / 2

    if not cfg.no_head_pose:
        head_gt, head_pred = motion_coef_gt[..., 50:53], target[..., 50:53]
        if cfg.l_head_angle > 0:
            out["head_angle"] = _masked_mean(crit(head_gt, head_pred), mask) / 2
        if cfg.l_head_vel > 0:
            out["head_vel"] = _masked_mean(crit(diff(head_gt), diff(head_pred)), mask[:, 1:]) / 2
        if cfg.l_head_smooth > 0:
            hvp = diff(head_pred)
            out["head_smooth"] = _masked_mean(crit(hvp[:, 1:], hvp[:, :-1]), mask[:, 2:]) / 2
        if not is_starting_sample and cfg.l_head_trans > 0:
            out["head_trans"] = _head_trans_loss(crit, head_gt, head_pred, cfg.n_prev_motions, mask)
    return out


def compute_loss_espnet(cfg, is_starting_sample: bool, shape_coef, motion_coef_gt: torch.Tensor,
                        noise: torch.Tensor, target: torch.Tensor, prev_motion_coef: Optional[torch.Tensor],
                        coef_stats, gt_vertices: torch.Tensor, seq_vertices: torch.Tensor,
                        end_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The precomputed-vertices variant (``msmd_tpu/losses.py``:330-394;
    reference: utils/common.py:622-766): like ``compute_loss``, but the
    vertex terms compare ``gt_vertices`` with ``seq_vertices`` as unmasked
    means, and head pose is the last 3 channels. A target other than
    ``sample`` gives the noise term alone, over the starting window's
    mask."""
    crit = _criterion(cfg.criterion)
    B, dev = motion_coef_gt.shape[0], target.device
    zero = torch.zeros((), dtype=target.dtype, device=dev)
    out = {k: zero for k in LOSS_KEYS}

    if cfg.target != "sample":
        mask = _base_mask(cfg, B, end_idx, True, dev)
        out["noise"] = _masked_mean(crit(noise, target[:, cfg.n_prev_motions:]), mask) / 2
        return out

    if is_starting_sample:
        target = target[:, cfg.n_prev_motions:]
    else:
        motion_coef_gt = torch.cat([prev_motion_coef, motion_coef_gt], dim=1)
        if cfg.no_constrain_prev:
            target = torch.cat([prev_motion_coef, target[:, cfg.n_prev_motions:]], dim=1)
    mask = _base_mask(cfg, B, end_idx, is_starting_sample, dev)
    out["noise"] = _masked_mean(crit(motion_coef_gt, target), mask) / 2
    diff = lambda t: t[:, 1:] - t[:, :-1]

    if cfg.l_vert > 0 or cfg.l_vel > 0:
        if cfg.l_vert > 0:
            out["vert"] = crit(gt_vertices, seq_vertices).mean() / 2
        if cfg.l_vel > 0:
            out["vel"] = crit(diff(gt_vertices), diff(seq_vertices)).mean() / 2
        if cfg.l_smooth > 0:
            vp = diff(seq_vertices)
            out["smooth"] = crit(vp[:, 1:], vp[:, :-1]).mean() / 2

    if not cfg.no_head_pose:
        head_gt, head_pred = motion_coef_gt[..., -3:], target[..., -3:]
        if cfg.l_head_angle > 0:
            out["head_angle"] = _masked_mean(crit(head_gt, head_pred), mask) / 2
        if cfg.l_head_vel > 0:
            out["head_vel"] = _masked_mean(crit(diff(head_gt), diff(head_pred)), mask[:, 1:]) / 2
        if cfg.l_head_smooth > 0:
            hvp = diff(head_pred)
            out["head_smooth"] = _masked_mean(crit(hvp[:, 1:], hvp[:, :-1]), mask[:, 2:]) / 2
        if not is_starting_sample and cfg.l_head_trans > 0:
            out["head_trans"] = _head_trans_loss(crit, head_gt, head_pred, cfg.n_prev_motions, mask)
    return out


# ---------------------------------------------------------------------------
# auxiliary losses (the reference defines them but does not train with them)
# ---------------------------------------------------------------------------

def style_adherence_loss(x_pred: torch.Tensor, style_frames: torch.Tensor, use_soft_min: bool = True,
                         lambda_softmin: float = 10.0, reduce: bool = True) -> torch.Tensor:
    """Soft-min MSE of predicted frames (B, T, D) against style-clip frames
    (B, K, D) (reference: utils/common.py:29-91): each frame's mean squared
    distance to every style frame, weighted by softmax(-lambda d); with
    ``use_soft_min`` False the hard minimum (always reduced)."""
    d = ((x_pred[:, :, None] - style_frames[:, None]) ** 2).mean(-1)  # (B, T, K)
    if use_soft_min:
        per_frame = (torch.softmax(-lambda_softmin * d, dim=-1) * d).sum(-1)  # (B, T)
        return per_frame.mean() if reduce else per_frame
    return d.min(dim=-1).values.mean()


def nt_xent_loss(feature_a: torch.Tensor, feature_b: torch.Tensor, temperature: float) -> torch.Tensor:
    """SimCLR's normalised-temperature cross-entropy of two views (B, D)
    (reference: utils/common.py:835-875): row i's positive is the other
    view of sample i, its negatives the other 2B - 2 rows."""
    B = feature_a.shape[0]
    features = torch.cat([feature_a, feature_b], dim=0)
    features = features / torch.linalg.norm(features, dim=1, keepdim=True)
    sim = features @ features.T  # (2B, 2B)
    n = 2 * B
    labels = torch.arange(B, device=sim.device).repeat(2)
    pos_mask = labels[None, :] == labels[:, None]
    off = ~torch.eye(n, dtype=torch.bool, device=sim.device)
    sim_off = sim[off].reshape(n, n - 1)
    pos_off = pos_mask[off].reshape(n, n - 1)
    logits = torch.cat([sim_off[pos_off].reshape(n, -1), sim_off[~pos_off].reshape(n, -1)], dim=1) / temperature
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()  # the positive sits at column 0


def _truncate_seq(x: torch.Tensor, end_idx: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Zero (or replicate the last kept frame) at and after ``end_idx``
    along axis 1, per batch row."""
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < end_idx.to(x.device)[:, None]
    keep = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
    if pad_mode == "zero":
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    if pad_mode == "replicate":
        idx = (end_idx.to(x.device) - 1).reshape(-1, *([1] * (x.ndim - 1))).expand(-1, 1, *x.shape[2:])
        return torch.where(keep, x, torch.gather(x, 1, idx))
    raise ValueError(f"Unknown pad mode {pad_mode}!")


def truncate_motion_coef_and_audio(audio: torch.Tensor, motion_coef: torch.Tensor, end_idx: torch.Tensor,
                                   audio_unit: float = 640.0, pad_mode: str = "zero"):
    """End-truncation of an (audio, motion) window at the per-sample frame
    ``end_idx`` (reference: utils/common.py:816-832). The caller draws
    ``end_idx`` in [1, n_motions). Returns (audio, motion)."""
    audio_end = (end_idx.to(torch.float32) * audio_unit).to(torch.int64)
    return _truncate_seq(audio, audio_end, pad_mode), _truncate_seq(motion_coef, end_idx, pad_mode)


def truncate_coef_dict_and_audio(audio: torch.Tensor, coef_dict: Dict[str, torch.Tensor], end_idx: torch.Tensor,
                                 audio_unit: float = 640.0, pad_mode: str = "zero"):
    """The dict variant (reference: utils/common.py:804-814): every
    coefficient track of ``coef_dict`` truncated at ``end_idx`` beside the
    audio. The caller draws ``end_idx`` in [1, n_motions). Returns (audio,
    coef_dict)."""
    audio_end = (end_idx.to(torch.float32) * audio_unit).to(torch.int64)
    return _truncate_seq(audio, audio_end, pad_mode), {k: _truncate_seq(v, end_idx, pad_mode)
                                                       for k, v in coef_dict.items()}


def load_loss_weights(cfg) -> Dict[str, float]:
    """Loss weights (reference: training_script.py:406-438)."""
    w = {
        "noise": 1.0,
        "vert": float(cfg.l_vert),
        "vel": float(cfg.l_vel),
        "smooth": float(cfg.l_smooth),
        "head_angle": float(cfg.l_head_angle),
        "head_vel": float(cfg.l_head_vel),
        "head_smooth": float(cfg.l_head_smooth),
        "head_trans": float(cfg.l_head_trans),
    }
    if not cfg.use_vertex_space:
        w["vel"] *= 4.5e-8
        w["smooth"] *= 4e-7
    if not is_hdtf(cfg.dataset_type) and cfg.use_vertex_space:
        w["vert"] *= 1e-7
        w["vel"] *= 1e-7
        w["smooth"] *= 2e-8
    if cfg.training_loss_style == "MSMD":
        w["kl_div"] = float(cfg.l_kl_div)
    return w
