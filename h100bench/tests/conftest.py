"""Shared pieces of the benchmark's tests: a tiny configuration of the
flagship's file (every width cut, so the CPU runs it in seconds) and the
cells' traffic at matching tiny sizes."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench import harness  # noqa: E402


def tiny_config(name: str = "msmd") -> dict:
    """A configuration file with every width and depth cut (HuBERT keeps
    three layers, so one of them trains)."""
    cfg = json.loads((ROOT / "h100bench" / "configs" / f"{name}.json").read_text())
    cfg["model"].update(feature_dim=64, n_heads=1, n_layers=1, mlp_ratio=2, n_motions=8, n_prev_motions=4,
                        n_diff_steps=3, d_style=16)
    cfg["audio"].update(hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64, conv_dim=[32] * 7,
                        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    cfg["flame"]["n_verts"] = 64
    return cfg


TINY_TRAFFIC = {
    "offline": dict(mode="offline", batch=4, clip_seconds=[0.5, 0.9], style_frames=12, dynamic_threshold=[0, 1, 4],
                    check_rows=3, check_frames=3, trace_units=1),
    "live": dict(mode="live", batch=1, utterance_seconds=0.32, style_frames=12,
                 dynamic_threshold=None, check_requests=3, check_frames=3, trace_units=2),
    "stream": dict(mode="stream", slots=4, pipeline_depth=2, clients=6, stream_seconds=0.96, warmup_seconds=0.64,
                   style_frames=12, dynamic_threshold=None, check_streams=6, trace_units=1),
    "train": dict(mode="train", batch=3, check_steps=3, warmup_steps=1, trace_units=1),
}
CELL_OF_MODE = {"offline": "msmd.offline48", "live": "msmd.live1", "stream": "msmd.stream48",
                "train": "msmd-hdtf-vertex.train16"}
CONFIG_OF_MODE = {"train": "msmd-hdtf-vertex"}


def tiny_cell(mode: str, config=None) -> harness.Cell:
    """The mode's cell at tiny sizes, held to the real cell's limits."""
    real = harness.Cell.load(CELL_OF_MODE[mode])
    config = config or tiny_config(CONFIG_OF_MODE.get(mode, "msmd"))
    return harness.Cell(f"tiny.{mode}", 1, config, copy.deepcopy(TINY_TRAFFIC[mode]),
                        real.limits, real.end_to_end, real.per_layer)


def cpu_run(mode_name: str, seed: int = 2 ** 31 + 12345, control: bool = False, cell=None):
    """Set-up, a short window and the check of a tiny cell on the CPU:
    (context, run, readings)."""
    cell = cell or tiny_cell(mode_name)
    mode = harness.mode_of(cell)
    ctx = harness.Context(cell, seed, 0.0, False, torch.device("cpu"))
    mode.setup(ctx)
    run = mode.window(ctx, None, min_units=mode.calibration_units(cell))
    return ctx, run, mode.check(ctx, run, control=control)


@pytest.fixture
def one_thread():
    """One intra-op thread, restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
