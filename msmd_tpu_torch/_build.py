"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` at first use (the hash is
of the source and of the shared headers ``csrc/*.cuh``, so an edited
kernel is rebuilt), then loaded with ``ctypes``. Nothing is built when a module is imported: the CPU tests
import every module on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc was not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def sources() -> List[str]:
    """The name of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc``
    process per source, all started together. Returns each compiler's
    output (register and shared-memory use from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def ptxas_entries(log: str) -> Dict[str, dict]:
    """Each function of one library's ``-Xptxas -v`` output (``build``'s
    log), by its mangled name: registers, stack frame and spill bytes."""
    out: Dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            out[entry].update(zip(("stack_frame", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.msmd_error_string.argtypes = [ctypes.c_int]
        lib.msmd_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({lib.msmd_error_string(rc).decode()})")


def on_cpu(name: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version), False
    for a CUDA tensor (it launches its kernel); raises for any other
    device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cpu"


def check_args(name: str, device: torch.device, **named) -> None:
    """Raise unless every ``named`` value ``(tensor, shape, dtype)`` is a
    contiguous tensor of that shape and dtype on ``device``."""
    for key, (t, shape, dtype) in named.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a C entry point."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``, read
    without making a ``torch.cuda.Stream`` (a few microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(index)
