"""Configuration for the PyTorch / CUDA port.

This is the port's own copy of ``msmd_tpu/config.py`` (the port imports
nothing from the JAX package), plus the audio-encoder architecture
config (``msmd_tpu/models/audio.py::AudioEncoderConfig``). Field names
and defaults are identical, so an ``args.json`` written by either
package configures the other.

One explicit, serializable dataclass replaces the reference's argparse
Namespace + implicit DiffPoseTalk-lineage args (reference:
training_script.py:446-515 for the declared flags; model.py /
utils/common.py consume the undeclared ones — see ``IMPLICIT_FIELDS``).

The config round-trips through the reference's ``args.json`` surface
(reference: utils/model_common.py:9-55) so checkpoints remain
interoperable in both directions.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


@dataclass
class MSMDConfig:
    # ---- mode / experiment (reference: training_script.py:449-457) ----
    mode: str = "train"
    exp_name: str = "msmd_tpu"
    data_root: str = ""
    max_iter: int = 2_000_000
    batch_size: int = 16
    num_workers: int = 2

    # ---- model family (reference: training_script.py:459-473) ----
    generator_model_style: str = "MSMD"
    style_enc_model_style: str = "vae2"
    training_loss_style: str = "MSMD"
    dataset_type: str = "ravdess+celebv-text-medium"
    audio_model: str = "hubert"  # 'hubert' | 'wav2vec2' | 'wavlm'
    d_style: int = 256

    # ---- feature options (reference: training_script.py:475-480) ----
    use_indicator: bool = True
    use_cross_style: bool = True
    use_vertex_space: bool = False
    num_of_basis: int = 4
    prob_cross_style: float = 0.5

    # ---- loss weights (reference: training_script.py:482-490) ----
    l_vert: float = 1.0
    l_vel: float = 0.5
    l_smooth: float = 10.0
    l_kl_div: float = 1e-7
    l_head_angle: float = 1.0
    l_head_vel: float = 0.5
    l_head_smooth: float = 0.5
    l_head_trans: float = 0.5

    # ---- optimization (reference: training_script.py:492-498) ----
    scheduler: str = "Warmup"  # 'Warmup' | 'WarmupThenDecay'
    lr: float = 2e-5
    warm_iter: int = 5000
    cos_max_iter: int = 1_000_000
    min_lr_ratio: float = 0.1
    gradient_accumulation_steps: int = 1

    # ---- sequence geometry (reference: training_script.py:500-507) ----
    # NOTE: the reference declares n_motions=750 / n_prev_motions=100 /
    # fps=30 as argparse defaults but its dataset hardcodes the working
    # geometry (datasets.py:167,238: 100-frame windows @ 25 fps, 640
    # samples/frame). We default to the geometry that actually runs.
    n_motions: int = 100
    n_prev_motions: int = 10
    fps: int = 25
    trunc_prob1: float = 0.5
    trunc_prob2: float = 0.5
    pad_mode: str = "zero"  # 'zero' | 'replicate'
    rot_repr: str = "euler"

    # ---- misc switches (reference: training_script.py:509-517) ----
    no_head_pose: bool = False
    do_ignore_shape: bool = False
    do_ignore_cfg: bool = False
    log_iter: int = 100
    save_iter: int = 10000
    val_iter: int = 10000
    # Training and parallelism switches of the JAX package, kept so that
    # an args.json round-trips; the port's inference path reads none.
    val_batches_cap: int = 0
    fused_ffn_train: bool = False
    identity_band_train: bool = True
    remat_denoiser: bool = False
    two_clip_batch: bool = False
    tp_size: int = 1
    log_smooth_win: int = 50
    continue_from: Optional[str] = None

    # ---- implicit DiffPoseTalk-lineage fields -------------------------
    # Consumed but never declared by the reference CLI (see SURVEY.md
    # §2.4); these carry the defaults of its released checkpoints.
    target: str = "sample"  # 'noise' | 'sample'         (model.py:78)
    criterion: str = "l2"  # 'l1' | 'l2'       (utils/common.py:220)
    architecture: str = "decoder"  # (model.py:114)
    feature_dim: int = 512  # (model.py:844)
    n_heads: int = 8
    n_layers: int = 8
    mlp_ratio: int = 4
    align_mask_width: int = 1  # (model.py:879)
    no_use_learnable_pe: bool = False  # (model.py:862)
    n_diff_steps: int = 500  # (model.py:125)
    diff_schedule: str = "cosine"  # (model.py:125)
    cfg_mode: str = "incremental"  # 'independent' | 'incremental'
    guiding_conditions: str = "style,audio"  # (model.py:128)
    style_enc_ckpt: Optional[str] = None  # (model.py:8-11)
    no_constrain_prev: bool = False  # (utils/common.py:246)
    regularize_alpha: str = "None"  # 'None' | 'sigmoid' (model.py:12-15)

    # ---- additions of the JAX package (no reference equivalent) -------
    compute_dtype: str = "bfloat16"  # matmul/activation dtype
    attn_softmax_dtype: str = ""  # kept for args.json; the port promotes to f32
    param_dtype: str = "float32"  # parameter storage dtype
    mesh_shape: str = "data"
    flame_model_path: Optional[str] = None  # FLAME generic_model.pkl
    coef_stats_path: Optional[str] = None  # normalization stats pkl/npz
    seed: int = 0
    # non-default audio-encoder architecture (AudioEncoderConfig kwargs),
    # persisted through args.json so inference rebuilds the same model
    audio_encoder_config: Optional[Dict[str, Any]] = None

    # -------------------------------------------------------------------
    @property
    def motion_feat_dim(self) -> int:
        """67 = 64-dim expression code + 3-dim head rotation
        (reference: model.py:83)."""
        return 67

    @property
    def shape_feat_dim(self) -> int:
        return 100

    @property
    def use_style(self) -> bool:
        """Style conditioning is on whenever a style encoder exists
        (reference: model.py:82 — vae_style=True for MSMD)."""
        return True

    @property
    def guiding_condition_list(self):
        conds = self.guiding_conditions.split(",") if self.guiding_conditions else []
        return [c for c in conds if c in ("style", "audio")]

    @property
    def audio_unit(self) -> float:
        """Audio samples per motion frame (reference: datasets.py:238)."""
        return 16000.0 / self.fps

    @property
    def n_audio_samples(self) -> int:
        """Raw-audio window length fed to the audio encoder (the collate
        pads to exactly this: reference datasets.py:458)."""
        return round(self.audio_unit * self.n_motions)

    # ---- serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save_args_json(self, save_dir) -> None:
        """Emit the reference-compatible ``args.json``: drop None/'None'
        values, stringify paths (reference: utils/model_common.py:9-27)."""
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        d = {}
        for k, v in self.to_dict().items():
            if v is None or v == "None":
                continue
            if isinstance(v, Path):
                v = str(v)
            d[k] = v
        with open(save_dir / "args.json", "w") as f:
            json.dump(d, f)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MSMDConfig":
        """Build from a dict, backfilling unknown keys with defaults and
        mapping the reference's legacy aliases (reference:
        utils/common.py:9-26 NullableArgs shims)."""
        d = dict(d)
        # legacy shims
        if "use_alignment_mask" in d and "align_mask_width" not in d:
            d["align_mask_width"] = 1 if d.pop("use_alignment_mask") else 0
        if "predict_head_pose" in d and "no_head_pose" not in d:
            d["no_head_pose"] = not d.pop("predict_head_pose")
        if "use_learnable_pe" in d and "no_use_learnable_pe" not in d:
            d["no_use_learnable_pe"] = not d.pop("use_learnable_pe")
        names = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in d.items() if k in names}
        return cls(**kept)

    @classmethod
    def load_args_json(cls, save_dir) -> "MSMDConfig":
        with open(Path(save_dir) / "args.json") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "MSMDConfig":
        return dataclasses.replace(self, **kw)


def is_hdtf(dataset_type: str) -> bool:
    """Whether ``dataset_type`` has the HDTF / FLAME coefficient layout: a
    54-wide style input, and the vertex-space loss at its own weights
    (reference: training_script.py:428, style_encoder.py:7-12)."""
    return dataset_type[:9] == "HDTF_TFHP" or dataset_type == "flame_mead_ravdess"


@dataclass(frozen=True)
class AudioEncoderConfig:
    """wav2vec2 / HuBERT base architecture (facebook/hubert-base-ls960);
    the same fields and defaults as the JAX package's config, and the
    port's own five layout fields after them, whose defaults are that
    base layout:

    - ``feat_extract_norm``: "group" (a per-channel GroupNorm after the
      first convolution) or "layer" (a LayerNorm over channels after every
      convolution);
    - ``conv_bias``: the convolutions carry a bias;
    - ``do_stable_layer_norm``: pre-LN encoder layers, a final LayerNorm
      after the last one and none before the first;
    - ``num_buckets`` / ``max_bucket_distance``: WavLM's gated
      relative-position attention over that many buckets (0: none).

    ``WAVLM_LARGE`` is microsoft/wavlm-large."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # SpecAugment (training only; the port's inference path never masks)
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    # the port's layouts (defaults: the base layout above)
    feat_extract_norm: str = "group"
    conv_bias: bool = False
    do_stable_layer_norm: bool = False
    num_buckets: int = 0
    max_bucket_distance: int = 800

    def __post_init__(self):
        if self.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm must be 'group' or 'layer', got {self.feat_extract_norm!r}")
        if self.num_buckets < 0 or self.num_buckets % 2:
            raise ValueError(f"num_buckets must be 0 or a positive even number, got {self.num_buckets}")

    @property
    def relative_position(self) -> bool:
        """WavLM's gated relative-position attention."""
        return self.num_buckets > 0


_LAYOUT_FIELDS = ("feat_extract_norm", "conv_bias", "do_stable_layer_norm", "num_buckets", "max_bucket_distance")

# microsoft/wavlm-large (config.json; Chen et al., arXiv:2110.13900)
WAVLM_LARGE = AudioEncoderConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096, feat_extract_norm="layer",
    conv_bias=False, do_stable_layer_norm=True, num_buckets=320, max_bucket_distance=800)

AUDIO_MODELS = ("hubert", "wav2vec2", "wavlm")


def default_audio_config(audio_model: str) -> AudioEncoderConfig:
    """The encoder ``audio_model`` names at its published widths: the base
    layout for hubert and wav2vec2, ``WAVLM_LARGE`` for wavlm."""
    if audio_model not in AUDIO_MODELS:
        raise ValueError(f"audio_model must be one of {AUDIO_MODELS}, got {audio_model!r}")
    return WAVLM_LARGE if audio_model == "wavlm" else AudioEncoderConfig()


def audio_config_to_dict(c: AudioEncoderConfig) -> Dict[str, Any]:
    """``c`` as ``args.json``'s ``audio_encoder_config``: the layout fields
    only where they leave the base layout, so a base-layout config still
    reads in the JAX package, which has none of them."""
    d = dataclasses.asdict(c)
    base = AudioEncoderConfig()
    for k in _LAYOUT_FIELDS:
        if d[k] == getattr(base, k):
            del d[k]
    return d


def audio_config_from_dict(d: Dict[str, Any]) -> AudioEncoderConfig:
    """The inverse of ``audio_config_to_dict`` (lists back to tuples)."""
    return AudioEncoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})
