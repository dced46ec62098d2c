"""Data parallelism: one process per rank over a `torch.distributed`
process group (counterpart: `emsanet_tpu/parallel/mesh.py`).

The JAX package runs one program over a 1-D 'data' mesh (`shard_map`):
the global batch is cut into contiguous blocks on axis 0, the state is
replicated, each device runs the forward and backward on its block with
its own BatchNorm batch statistics, and the gradients, the losses and
the new BatchNorm running statistics are `pmean`-ed over the mesh before
the update. The port gives the same numbers with one process per rank:

- `Mesh` is the process group, the rank, the world size and the rank's
  device (`init_mesh` joins the group). `check_devices` refuses more
  ranks than visible devices with `create_mesh`'s message (on the CPU, as `main.py --device cpu`, 8
  virtual devices). The backend follows the topology, never an error:
  gloo for CPU ranks, NCCL for one card per rank, gloo on CUDA tensors
  for ranks that share one card (`dryrun.py` and `chip_smoke.py` only:
  NCCL refuses two ranks on one card).
- `rank_rows` takes rank r's rows [r B/n, (r+1) B/n) of a global batch
  (the loaders load only those, `data.py`); `concat_rows` puts the ranks'
  rows back together.
- `all_mean_` replaces tensors by their mean over the ranks in place,
  with one `all_reduce` per dtype over a flat copy of all of them: the
  train step (`training/step.py`) sends the gradients, the BatchNorm
  running statistics and the losses through one call after `backward()`
  (the JAX package's `pmean`s; mean = sum / n). Every rank receives the
  same bits, so the replicas stay identical.
- `broadcast_` copies rank 0's tensors to every rank (the trainer's
  start, after loading); `gather_to_main` collects a picklable object of
  every rank on rank 0 (validation: predictions and ground truth).
- `launch` starts n ranks (spawned processes), each joining a group
  through a file store, runs `fn(mesh, *args)` in each and returns the
  ranks' results; a rank that fails or outlives `timeout` fails the call.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the devices `--device cpu` offers, as `main.py:40-46` gives JAX 8
# virtual CPU devices
CPU_DEVICES = 8
# a collective that waits longer than this fails its rank
COLLECTIVE_TIMEOUT_S = 600


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group (the default process
    group)."""

    rank: int
    size: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def available_devices(device_type: str) -> int:
    return (torch.cuda.device_count() if device_type == "cuda"
            else CPU_DEVICES)


def check_devices(n_devices: int, device_type: str) -> None:
    """`create_mesh`'s check (`emsanet_tpu/parallel/mesh.py:39-44`)."""
    have = available_devices(device_type)
    if have < n_devices:
        raise ValueError(f"Requested {n_devices} devices but only {have} "
                         "available.")


def check_batch_sizes(batch_size: int, validation_batch_size: int,
                      n: int) -> None:
    """`main.py:175-186`: both batch sizes must divide over the mesh."""
    for name, bs in (("batch_size", batch_size),
                     ("validation_batch_size", validation_batch_size)):
        if bs % n != 0:
            raise ValueError(f"{name}={bs} must be a multiple of the "
                             f"{n}-device mesh")


def backend_for(device_type: str, shared_card: bool) -> str:
    """gloo for CPU ranks and for ranks that share a card, NCCL for one
    card per rank."""
    return "nccl" if device_type == "cuda" and not shared_card else "gloo"


def rank_device(device_type: str, local_rank: int,
                shared_card: bool) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", 0 if shared_card else local_rank)


def init_mesh(rank: int, size: int, device: torch.device, init_method: str,
              shared_card: bool = False) -> Mesh:
    """Join the default process group; the backend follows the
    topology (`backend_for`)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device.type, shared_card)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kwargs)
    return Mesh(rank, size, device)


def mesh_from_env(device_type: str) -> Mesh:
    """A rank started by torchrun (`--distributed`): RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT from its environment, one
    card per rank."""
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        check_devices(local + 1, device_type)
    return init_mesh(rank, size, rank_device(device_type, local, False),
                     "env://")


def close_mesh(mesh: Optional[Mesh]) -> None:
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# batches


def _rows(value: Any, lo: int, hi: int) -> Any:
    if isinstance(value, dict):
        return {k: _rows(v, lo, hi) for k, v in value.items()}
    return value[lo:hi]


def rank_rows(batch: Dict[str, Any], rank: int, size: int) -> Dict[str, Any]:
    """Rows [rank B/size, (rank+1) B/size) of every entry of a collated
    batch (arrays, lists and the `_down_{s}` sub-batches alike)."""
    n = len(batch["_valid_mask"]) if "_valid_mask" in batch else len(
        next(iter(batch.values())))
    lo, hi = rank * n // size, (rank + 1) * n // size
    return {k: _rows(v, lo, hi) for k, v in batch.items()}


def concat_rows(parts: Sequence[Any]) -> Any:
    """The inverse of `rank_rows`: the ranks' batches, in rank order."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: concat_rows([p[k] for p in parts]) for k in first}
    if isinstance(first, np.ndarray):
        return np.concatenate(parts, axis=0)
    return [v for p in parts for v in p]


# ---------------------------------------------------------------------------
# collectives


def all_mean_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor becomes its mean over the ranks (sum / n), in place:
    one `all_reduce` per dtype over a flat copy of all of them."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat.div_(mesh.size)
        _scatter_flat(flat, ts)


def broadcast_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values into every rank's tensors, in place: one
    `broadcast` per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0)
        _scatter_flat(flat, ts)


def _scatter_flat(flat: torch.Tensor, ts: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def gather_to_main(mesh: Mesh, obj: Any) -> Optional[List[Any]]:
    """Every rank's `obj` on rank 0, in rank order (None elsewhere)."""
    out = [None] * mesh.size if mesh.is_main else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------------
# starting ranks


def _rank_main(rank: int, fn: Callable, size: int, device_type: str,
               init_method: str, shared_card: bool, threads: Optional[int],
               out_dir: str, args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    mesh = init_mesh(rank, size, rank_device(device_type, rank, shared_card),
                     init_method, shared_card)
    try:
        result = fn(mesh, *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        close_mesh(mesh)


def launch(fn: Callable, n: int, device_type: str, *args,
           shared_card: bool = False, threads: Optional[int] = None,
           timeout: Optional[float] = 1800.0) -> List[Any]:
    """Run `fn(mesh, *args)` in n spawned ranks (rank r on card r, or all
    on card 0 with `shared_card`, or on the CPU) that join one group
    through a file store; returns their results in rank order. `fn`, its
    arguments and results must pickle. CPU ranks share this process's
    intra-op threads unless `threads` is given. Raises if a rank fails
    or the ranks outlive `timeout` seconds (None: no limit); the rest
    are then stopped."""
    import torch.multiprocessing as mp

    if threads is None and device_type == "cpu":
        threads = max(1, torch.get_num_threads() // n)

    if device_type == "cuda" and shared_card:
        check_devices(1, device_type)
    else:
        check_devices(n, device_type)
    tmp = tempfile.mkdtemp(prefix="emsanet_ranks_")
    try:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, nprocs=n, join=False, start_method="spawn",
            args=(fn, n, device_type, init_method, shared_card, threads,
                  tmp, args))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{n} ranks outlived {timeout:.0f} s")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
