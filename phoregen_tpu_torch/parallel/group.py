"""Data parallelism over processes: the counterpart of
`phoregen_tpu/parallel/mesh.py`.

The JAX package runs one program over a 1-D `data` mesh: parameters,
optimizer state and EMA replicated, the batch axis sharded, the gradient
reduction inserted by sharded autodiff. Here each device is one process
of a `torch.distributed` process group (NCCL on `cuda`, gloo on `cpu`):
every rank holds the whole state, assembles only its slice of each global
batch (`local_batch_slice`, `data/loader.py`), and the train step reduces
explicitly (`train/step.py`): the sums the loss divides before the loss is
formed (`sum_over_ranks`), the gradients after the backward
(`reduce_gradients`).

A process per device comes from `launch` (`torch.multiprocessing.spawn`,
with a `file://` rendezvous in a fresh temporary directory, so that
concurrent launches never race for a TCP port) or from a `torchrun`
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`: `init_method
'env://'`). Outside a process group everything here is the one-process
case: world size 1, rank 0, no collective.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def device_for(local_rank: int, kind: str = "cuda") -> torch.device:
    """The device of the rank with `local_rank` on its host:
    `cuda:{local_rank}`, or the CPU."""
    return torch.device(f"cuda:{local_rank}" if kind == "cuda" else "cpu")


def device_count(requested: int, kind: str, what: str) -> int:
    """The number of devices `requested` stands for: 0 = every visible
    CUDA device (one on the CPU). More CUDA devices than are visible is a
    SystemExit that names both numbers."""
    if kind != "cuda":
        return max(requested, 1)
    visible = torch.cuda.device_count()
    n = requested if requested > 0 else visible
    if n > visible:
        raise SystemExit(f"[E] {what} asks for {n} CUDA devices, but "
                         f"{visible} are visible")
    return max(n, 1)


def init(rank_: int, world: int, init_method: str, device: torch.device,
         backend: Optional[str] = None) -> None:
    """Join the process group as `rank_` of `world` on `device`. The
    backend is NCCL for a CUDA device and gloo for the CPU unless named:
    gloo on CUDA tensors is the way to run several ranks on one card,
    which NCCL refuses. A failed initialisation raises."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_)


def init_from_env(device_kind: str = "cuda") -> torch.device:
    """Join the process group that `torchrun` describes (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`); returns this rank's device."""
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device = device_for(local, device_kind)
    init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
         device)
    return device


def in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (picklable)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def local_batch_slice(global_batch_size: int) -> slice:
    """This rank's rows of a global batch (the `DistributedSampler`
    replacement): contiguous blocks in rank order."""
    n = world_size()
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} not divisible by world size {n}")
    per = global_batch_size // n
    i = rank()
    return slice(i * per, (i + 1) * per)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place; `t` itself outside a group."""
    if is_initialized():
        dist.all_reduce(t)
    return t


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over ranks. Backward: the gradient as it is, so
    that each rank's backward gives the derivative of the (global) loss
    through its own rows; `reduce_gradients` then sums those."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks (see `_SumOverRanks`)."""
    return _SumOverRanks.apply(x) if is_initialized() else x


def reduce_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks in one bucket. A
    parameter that has a gradient on any rank gets the sum on all (a zero
    stands in where a rank had none); one that has none anywhere keeps
    None, as in one process on the global batch."""
    if not is_initialized():
        return
    params = list(params)
    dev = params[0].device
    parts = [p.grad.reshape(-1).float() if p.grad is not None
             else torch.zeros(p.numel(), device=dev) for p in params]
    flags = torch.tensor([float(p.grad is not None) for p in params],
                         device=dev)
    flat = all_reduce_sum(torch.cat(parts + [flags]))
    has = flat[-len(params):].tolist()
    off = 0
    for p, h in zip(params, has):
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).to(p.dtype) if h > 0 else None
        off += n


def _entry(rank_: int, worker: Callable, world: int, init_method: str,
           out_dir: str, args: tuple) -> None:
    result = worker(rank_, world, init_method, *args)
    with open(os.path.join(out_dir, f"result_{rank_}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(worker: Callable, world: int, args: tuple = (),
           timeout: Optional[float] = None) -> List:
    """Run `worker(rank, world, init_method, *args)` in `world` spawned
    processes and return what each returned, by rank. The worker joins
    the group itself (`init`, with the `init_method` given: a `file://`
    rendezvous in a temporary directory made for this launch). A worker
    that raises raises here; past `timeout` seconds the processes are
    killed and TimeoutError is raised."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="phoregen_group_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    try:
        ctx = mp.start_processes(_entry, (worker, world, init_method, tmp,
                                          tuple(args)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout} s")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
