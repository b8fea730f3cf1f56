"""ffmpeg subprocess helpers for offline visualisation (the port of
``msmd_tpu/utils/media.py``; reference: utils/media.py:6-35). They run on
the host and touch no tensor."""

from __future__ import annotations

import shlex
import subprocess
from pathlib import Path


def _run(cmd: str) -> None:
    result = subprocess.run(shlex.split(cmd))
    if result.returncode != 0:
        raise RuntimeError(f"ffmpeg failed ({result.returncode}): {cmd}")


def combine_video_and_audio(video_file, audio_file, output, quality: int = 17, copy_audio: bool = True) -> None:
    audio_codec = "-c:a copy" if copy_audio else ""
    _run(
        f"ffmpeg -i {video_file} -i {audio_file} -c:v libx264 -crf {quality} -pix_fmt yuv420p "
        f"{audio_codec} -fflags +shortest -y -hide_banner -loglevel error {output}"
    )


def combine_frames_and_audio(frame_files, audio_file, fps, output, quality: int = 17) -> None:
    _run(
        f"ffmpeg -framerate {fps} -i {frame_files} -i {audio_file} -c:v libx264 -crf {quality} "
        f"-pix_fmt yuv420p -c:a copy -fflags +shortest -y -hide_banner -loglevel error {output}"
    )


def convert_video(video_file, output, quality: int = 17) -> None:
    _run(
        f"ffmpeg -i {video_file} -c:v libx264 -crf {quality} -pix_fmt yuv420p "
        f"-fflags +shortest -y -hide_banner -loglevel error {output}"
    )


def reencode_audio(audio_file, output) -> None:
    _run(f"ffmpeg -i {audio_file} -y -hide_banner -loglevel error {output}")


def extract_frames(filename, output_dir, quality: int = 1) -> None:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    _run(
        f"ffmpeg -i {filename} -qmin 1 -qscale:v {quality} -y -start_number 0 "
        f"-hide_banner -loglevel error {output_dir / '%06d.jpg'}"
    )
