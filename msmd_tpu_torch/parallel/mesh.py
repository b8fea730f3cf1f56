"""Data parallelism and the (dp, tp) layout of ranks (the port of
``msmd_tpu/parallel/mesh.py`` and of ``make_dp_tp_mesh``).

JAX shards one program over a device mesh and lets XLA insert the
collectives. Here each device has a process of its own, started by
``torchrun`` (or ``spawn`` below), and the collectives are written out:

- ``make_layout`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. Without
  them (and without a process group already set up) it is one process
  with no process group, as before. Otherwise it joins the default group
  (NCCL on the card, gloo on the CPU) and builds the (dp, tp) groups:
  ranks ``r`` form tensor-parallel groups of ``tp`` consecutive ranks,
  and data-parallel groups run across them (``make_dp_tp_mesh``'s
  ``("data", "model")`` reshape of the devices).
- ``shard_batch`` gives a rank its rows of the global batch.
- ``average_grads`` all-reduces the gradients as one flat buffer, averaged
  over the data group; the trainer calls it before each update. One
  explicit all-reduce rather than ``DistributedDataParallel``: the step
  freezes parameters and some leave the graph (the last layer's cross q
  and k), which DDP refuses without an extra pass.
- ``full_tensor`` puts a tensor's slices back together on every rank of a
  group (along any dimension: a layer's tensor-parallel shards, or the
  ranks' rows of a batch, ``gather_rows``).

The collectives are ``all_reduce`` and ``broadcast`` only (an all-gather
is the all-reduce of a zero-filled buffer): gloo takes these on CUDA
tensors too, so two ranks can share one card for checks.

JAX's trainer falls back to fewer data shards, leaving devices idle,
when the batch does not divide; with a process per device there is no
idle rank to leave, so ``batch_size % dp != 0`` raises.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass
class Layout:
    """This process's place in a (dp, tp) layout of ``world`` ranks."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    tp: int = 1
    dp_group: Any = None
    tp_group: Any = None
    distributed: bool = False  # a process group is set up (its collectives run, also at world 1)

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, batch_size: int) -> torch.Tensor:
        """This rank's row indices (int64, CPU) of a global batch."""
        if batch_size % self.dp:
            raise ValueError(f"batch_size={batch_size} is not divisible by the {self.dp} data-parallel ranks")
        b = batch_size // self.dp
        return torch.arange(self.dp_rank * b, (self.dp_rank + 1) * b)

    def average_grads(self, params: Sequence[torch.Tensor], group=None) -> None:
        """Average the ``.grad`` of ``params`` over ``group`` (default the
        data group) in place, as one flat all-reduce (the same parameters
        have gradients on every rank: each runs the same graph)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not self.distributed or not grads:
            return
        group = self.dp_group if group is None else group
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        torch._foreach_copy_(grads, [part.view_as(g) for g, part in zip(grads, flat.split([g.numel() for g in grads]))])

    def average(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data group (metrics)."""
        if not self.distributed:
            return t
        t = t.to(torch.float32, copy=True)
        dist.all_reduce(t, group=self.dp_group)
        return t / dist.get_world_size(self.dp_group)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_layout(tp: int = 1, backend: Optional[str] = None) -> Layout:
    """The layout of this process. With a default process group already
    set up (``spawn``, or a caller's ``init_process_group``) it uses it;
    else with ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` in the environment
    (``torchrun``) it sets one up (``backend``: NCCL where CUDA is
    available, else gloo); else one process, no group."""
    tp = max(int(tp), 1)
    if not dist.is_initialized() and "RANK" in os.environ:
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        local = int(os.environ.get("LOCAL_RANK", 0))
        if backend == "nccl":
            torch.cuda.set_device(local)
        dist.init_process_group(backend)
    if not dist.is_initialized():
        if tp > 1:
            raise ValueError(f"tp_size={tp} needs {tp} processes (one per device): start them with torchrun")
        return Layout()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f"tp_size={tp} does not divide the world size {world}")
    dp = world // tp
    dp_group = tp_group = None
    for d in range(dp):  # every rank builds every group, in the same order
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank // tp == d:
            tp_group = g
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            dp_group = g
    return Layout(world=world, rank=rank, local_rank=int(os.environ.get("LOCAL_RANK", rank)), tp=tp,
                  dp_group=dp_group, tp_group=tp_group if tp > 1 else None, distributed=True)


def shard_batch(batch: Dict, layout: Layout) -> Dict:
    """This rank's rows of a global batch: axis 0 of every array or
    tensor (scalars as they are)."""
    if layout.dp == 1:
        return batch
    idx = layout.rows(next(v.shape[0] for v in batch.values() if getattr(v, "ndim", 0) >= 1))
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    return {k: v[lo:hi] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


def full_tensor(local: torch.Tensor, dim: int, group, rank: int, size: int) -> torch.Tensor:
    """The tensor of which ``local`` is the slice of ``rank`` among the
    ``size`` ranks of ``group``, each an equal slice along ``dim`` in rank
    order, on every rank (an all-reduce of a zero-filled buffer: exact)."""
    shape = list(local.shape)
    n = shape[dim]
    shape[dim] = n * size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.narrow(dim, rank * n, n).copy_(local)
    dist.all_reduce(full, group=group)
    return full


def gather_rows(local: torch.Tensor, total: int, group=None) -> torch.Tensor:
    """Each rank's equal share of ``total`` rows, in rank order, on every
    rank of ``group``."""
    world = dist.get_world_size(group)
    if local.shape[0] * world != total:
        raise ValueError(f"{world} ranks of {local.shape[0]} rows do not make {total}")
    return full_tensor(local, 0, group, dist.get_rank(group), world)


# ---------------------------------------------------------------------------
# a launcher for checks: ranks as spawned processes sharing a file store
# ---------------------------------------------------------------------------

def _child(fn, rank, world, backend, init_file, args, queue):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world, rank=rank)
        try:
            queue.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: str, init_file: str, args: tuple = (), timeout: float = 300.0
          ) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` spawned ranks joined through the file
    store ``init_file`` (a path that does not exist yet; never a fixed TCP
    port) and return each rank's result, in rank order. ``fn`` must be
    importable by its module path. Every child sets its threads to 1, and
    is joined within ``timeout`` seconds; a rank that fails, exits other
    than 0 or runs past it makes this raise (the others are stopped)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, backend, str(init_file), args, queue), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world - len(results)} rank(s) still running after {timeout} s")
            try:
                rank, ok, value = queue.get(timeout=min(left, 1.0))
            except queue_mod.Empty:  # look for a rank that died without a word
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} exited with {[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.is_alive() or p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawn: ranks did not exit cleanly: {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [results[r] for r in range(world)]
