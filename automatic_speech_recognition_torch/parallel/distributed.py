"""The process group of a data-parallel job (counterpart of
automatic_speech_recognition_tpu/parallel/distributed.py).

JAX runs one process per host and inserts its collectives itself.  The
port runs one process per GPU under torchrun:

    torchrun --nproc_per_node N -m automatic_speech_recognition_torch.train ...

`maybe_initialize` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), pins the process to cuda:LOCAL_RANK
and joins the group: NCCL for CUDA, gloo for the CPU (a caller may name
gloo for CUDA tensors too, as two ranks sharing one card need).  It joins
whenever the variables are set, WORLD_SIZE 1 included, and is a no-op
without them, so every entry point calls it unconditionally.

Gradients, BN statistics and loss normalizers go through all_reduce,
the state through broadcast; all_gather collects the per-rank generator
states into a checkpoint.  With --num_partitions k (tensor parallelism),
`model_grid` splits the world into a (data, model) grid of k-wide model
groups of consecutive ranks, as JAX's make_mesh reshapes its devices:
the data collectives then run over a data group (the ranks holding the
same columns of the model), the activation and weight gathers over a
model group (parallel/tensor_parallel.py).  Every buffer lives where the backend wants it
(comm_device): on the CPU under gloo, so two ranks sharing one card can
run gloo over CUDA tensors.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# flat buffers of the gradient all-reduce: a published-width LAS's
# 40 MB of float32 gradients go in two
BUCKET_BYTES = 32 << 20
Group = Optional[dist.ProcessGroup]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(device: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Join the process group torchrun's environment describes; True if a
    group is up.  `device` is the entry point's --device: its type picks
    the backend (nccl for cuda, gloo for cpu) unless `backend` names one.
    A CUDA process is pinned to cuda:LOCAL_RANK, and raises if that GPU
    does not exist."""
    if is_initialized():
        return True
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    kind = torch.device(device.split(",")[0]).type
    kwargs = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"LOCAL_RANK {local} asks for a GPU but CUDA "
                               "is not available on this host")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no GPU: only "
                f"{torch.cuda.device_count()} CUDA devices are visible")
        torch.cuda.set_device(local)
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, **kwargs)
    log.info("process group: rank %d of %d (local rank %d), %s over %s:%s",
             rank, world, local, backend, os.environ["MASTER_ADDR"],
             os.environ["MASTER_PORT"])
    return True


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and summaries."""
    return process_index() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0")) if is_initialized() else 0


def local_world_size() -> int:
    """The processes on this host: torchrun's LOCAL_WORLD_SIZE (the world
    size where a launcher does not set it, as one host's does not need
    to); 1 without a group."""
    if not is_initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


@dataclass(frozen=True)
class Grid:
    """This rank's place on the (data, model) grid of a job with
    num_partitions k: rank r sits at (data, model) = divmod(r, k).
    `data_group`: the ranks at this model index (None when the data axis
    is 1); `model_group`: the k ranks at this data index (None when k is
    1)."""
    data_index: int
    model_index: int
    data_group: Group
    model_group: Group


def model_grid(num_partitions: int) -> Grid:
    """Build the data and model groups of the world for num_partitions
    (every rank calls it, in the same order as the other collectives).
    With k = 1 the data group is the world's (world_group()); a group of
    one rank is None, the 'no collective' value."""
    world, rank = process_count(), process_index()
    k = num_partitions
    if world % k:
        raise ValueError(f"{world} processes not divisible by {k} "
                         "partitions")
    dp = world // k
    if k == 1:
        return Grid(rank, 0, world_group(), None)
    model_group = data_group = None
    if dp > 1:
        data_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(m, world, k)) for m in range(k)])
    if k < world:
        model_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(d * k, (d + 1) * k)) for d in range(dp)])
    else:
        model_group = dist.group.WORLD
    return Grid(rank // k, rank % k, data_group, model_group)


def world_group() -> Group:
    """The default group when it spans several processes, else None (the
    'no collective' value every function here accepts)."""
    return dist.group.WORLD if process_count() > 1 else None


def comm_device() -> torch.device:
    """Where a collective's buffer must live: the pinned GPU under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(tag: str) -> None:
    """Every process waits here for the others (no-op in one process)."""
    if process_count() <= 1:
        return
    log.debug("barrier: %s", tag)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward pass; the backward pass sums the
    incoming gradients over the group too, since every rank's loss
    depends on every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup
                   ) -> torch.Tensor:
    """The group's sum of x, differentiable (see _AllReduceSum)."""
    return _AllReduceSum.apply(x, group)


def reduced(x: torch.Tensor, group: dist.ProcessGroup,
            op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """The group's reduction of x (a detached copy; x is unchanged)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _buckets(tensors: Sequence[torch.Tensor], limit: int
             ) -> List[List[int]]:
    """Indices of `tensors` in runs of one dtype and device, each run at
    most `limit` bytes (a larger tensor has a run of its own)."""
    runs: List[List[int]] = []
    key, size = None, 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        k = (t.dtype, t.device)
        if not runs or k != key or size + nbytes > limit:
            runs.append([])
            key, size = k, 0
        runs[-1].append(i)
        size += nbytes
    return runs


def _each_flat(tensors: Sequence[torch.Tensor], limit: int, collective
               ) -> None:
    """Run `collective` on flat buffers of `tensors` (bucketed by dtype,
    device and `limit` bytes) on the backend's device, and copy the
    result back into the tensors."""
    dev = comm_device()
    for run in _buckets(tensors, limit):
        flat = torch.cat([tensors[i].detach().reshape(-1)
                          for i in run]).to(dev)
        collective(flat)
        offset = 0
        for i in run:
            t = tensors[i]
            with torch.no_grad():
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group: dist.ProcessGroup,
                    bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every tensor over the group, in place, a few flat buffers at a
    time."""
    _each_flat(tensors, bucket_bytes,
               lambda flat: dist.all_reduce(flat, group=group))


def broadcast_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup,
               src: int = 0) -> None:
    """Overwrite every tensor with rank `src`'s copy, in place."""
    _each_flat(tensors, BUCKET_BYTES,
               lambda flat: dist.broadcast(flat, src=src, group=group))


def broadcast_generator_(generator: torch.Generator,
                         group: dist.ProcessGroup, src: int = 0) -> None:
    """Give the generator rank `src`'s state."""
    state = generator.get_state()
    broadcast_([state], group, src)
    generator.set_state(state)


def gather_all(x: torch.Tensor, group: dist.ProcessGroup
               ) -> List[torch.Tensor]:
    """Every rank's copy of x (one shape on every rank: a generator
    state), in rank order, on the CPU."""
    x = x.to(comm_device())
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return [t.cpu() for t in out]


def rank_seed(seed: int, rank: int, stream: int) -> int:
    """A 63-bit seed for one rank's own stream `stream` of the job seeded
    with `seed` (numpy's SeedSequence mixes the three)."""
    state = np.random.SeedSequence([seed, rank, stream]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def any_flag(flags: Sequence[bool], group: Group) -> Tuple[bool, ...]:
    """Each flag OR-ed over the group (as given in one process)."""
    if group is None:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return tuple(bool(v) for v in t.tolist())


def destroy() -> None:
    """Leave the group, if one is up (an entry point's last call)."""
    if is_initialized():
        dist.destroy_process_group()
