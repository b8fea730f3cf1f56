"""The benchmark of the PyTorch / CUDA port (``msmd_tpu_torch``) on one
H100: ``python3 h100bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``. Nothing here imports JAX or the JAX package."""

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def prepare_env() -> None:
    """Before torch is imported: every build and kernel cache inside the
    checkout at a fixed path, and no JAX through a library that would
    load it by itself."""
    cache = ROOT / "h100bench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
