"""Single-pair inference CLI of the port, the twin of the root
``inference.py`` (reference: inference.py:189-287):

    python -m msmd_tpu_torch.inference --model_root ... --model_name ... --model_iter ... \\
        --style_clip_exp_code_path ... --style_clip_head_rot_path ... --audio_clip ... \\
        --coef_dict_path ... [--device cpu]

The same flags plus ``--device`` (default ``cuda``), the same outputs:
the normalised audio as a wav and, per seed, the denormalised expression
code and head rotation pkls under ``<output_dir>/<name>_iter_<iter>/temp/``.
``--batch_seeds`` runs all ``--versions_of_render`` seeds as one batch
from ``--seed``; otherwise seed i runs alone from generator seed i.
"""

from __future__ import annotations

import argparse
import os
import pickle as pkl
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Single inference for MSMD (PyTorch port).")
    parser.add_argument("--model_root", type=str, required=True, help="Root directory for models.")
    parser.add_argument("--model_name", type=str, required=True, help="Name of the model.")
    parser.add_argument("--model_iter", type=str, required=True, help="Checkpoint iteration (as string).")
    parser.add_argument("--style_clip_exp_code_path", type=str, required=True, help="Style clip expression-code pkl.")
    parser.add_argument("--style_clip_head_rot_path", type=str, required=True, help="Style clip head-rotation pkl.")
    parser.add_argument("--audio_clip", type=str, required=True, help="Input audio file (16 kHz wav).")
    parser.add_argument("--coef_dict_path", type=str, default="PATH-TO-COEF-STATS", help="Coefficient statistics pkl.")
    parser.add_argument("--cfg_level", type=float, default=1.4, help="CFG scale.")
    parser.add_argument("--output_dir", type=str, default="/experiments/refactor", help="Output directory.")
    parser.add_argument("--versions_of_render", type=int, default=1, help="Number of seeds to render.")
    parser.add_argument("--seed", type=int, default=0, help="Base generator seed.")
    parser.add_argument("--batch_seeds", action="store_true", help="Batch all seeds into one sampler call.")
    parser.add_argument("--device", type=str, default="cuda", help="Device to run on (cuda or cpu).")
    args = parser.parse_args(argv)

    import torch

    from msmd_tpu_torch.device import resolve_device
    from msmd_tpu_torch.inference_lib import infer_coeffs, load_audio_16k, load_model, load_style_clip

    dev = resolve_device(args.device)
    model, style_enc, cfg = load_model(args.model_root, args.model_name, args.model_iter, device=dev)
    with open(args.coef_dict_path, "rb") as f:
        coef_stats = pkl.load(f)
    to_np = lambda v: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
    coef_stats = {k: to_np(v) for k, v in coef_stats.items()}

    motion_coeff, shape_coef = load_style_clip(args.style_clip_exp_code_path, args.style_clip_head_rot_path,
                                               coef_stats, original_fps=30, target_fps=cfg.fps)
    audio_data = load_audio_16k(args.audio_clip)
    audio_data = (audio_data - audio_data.mean()) / (audio_data.std() + 1e-5)

    # style embedding from the first 100 style-clip frames (reference inference.py:239)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        style_coeff = style_enc.sample(torch.as_tensor(motion_coeff[:, :100], device=dev), generator=gen(args.seed))

    # output layout of the reference (inference.py:243-259)
    style_clip_name = os.path.splitext(os.path.basename(args.style_clip_exp_code_path))[0]
    audio_clip_name = os.path.splitext(os.path.basename(args.audio_clip))[0]
    output_clip_name = f"style=_{style_clip_name}_audio={audio_clip_name}"
    save_dir = os.path.join(args.output_dir, f"{args.model_name}_iter_{args.model_iter}")
    temp_subfolder = os.path.join(save_dir, "temp")
    os.makedirs(temp_subfolder, exist_ok=True)
    os.makedirs(os.path.join(save_dir, output_clip_name), exist_ok=True)

    from scipy.io import wavfile

    wavfile.write(os.path.join(temp_subfolder, f"{output_clip_name}.wav"), 16000, audio_data)

    R = args.versions_of_render

    def dump_seed(motion, count_i):
        motion = motion.float().cpu().numpy()
        exp_code = motion[:, :-3] * coef_stats["exp_std"] + coef_stats["exp_mean"]
        head_rot = motion[:, -3:] * coef_stats["pose_std"] + coef_stats["pose_mean"]
        for kind, arr in (("exp_code", exp_code), ("head_rot", head_rot)):
            name = f"overall_{kind}_{output_clip_name}_seed_{count_i}.pkl"
            with open(os.path.join(temp_subfolder, name), "wb") as f:
                pkl.dump(arr, f)

    run = lambda reps, seed: infer_coeffs(model, audio_data, shape_coef, audio_unit=640.0, style_feats=style_coeff,
                                          n_repetitions=reps, cfg_scale=args.cfg_level, dynamic_threshold=None,
                                          generator=gen(seed), device=dev)
    if args.batch_seeds:
        overall = run(R, args.seed)
        for count_i in range(R):
            dump_seed(overall[count_i], count_i)
    else:
        for count_i in range(R):
            dump_seed(run(1, count_i)[0], count_i)
    print(f"Wrote {R} seed(s) to {temp_subfolder}")


if __name__ == "__main__":
    main()
