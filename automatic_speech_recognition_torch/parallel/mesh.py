"""The devices of a data axis (counterpart of
automatic_speech_recognition_tpu/parallel/mesh.py).

JAX builds a ('data', 'model') jax.sharding.Mesh over every device and
lets GSPMD split the batch.  Here a Mesh lists the devices this process
drives along the data axis, and the process group that extends the axis
over other processes: evaluation splits a batch's rows over the local
devices of one process; training runs one process per GPU, so its mesh
holds this process's device and the group of all of them.  The model axis
is 1: tensor parallelism is ROADMAP item 12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import distributed

TENSOR_PARALLEL = ("--num_partitions > 1 (tensor parallelism) is not "
                   "ported yet (ROADMAP item 12)")


@dataclass
class Mesh:
    """`devices`: this process's devices, in the data axis's order;
    `group`: the processes the data axis spans (None: this one); `shape`:
    axis name -> size, as jax's Mesh.shape."""
    devices: List[torch.device]
    group: Optional[dist.ProcessGroup]
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def shape(self) -> Dict[str, int]:
        procs = dist.get_world_size(self.group) if self.group else 1
        return {self.data_axis: procs * len(self.devices),
                self.model_axis: 1}

    @property
    def size(self) -> int:
        return self.shape[self.data_axis]


def devices_for(name: str) -> List[torch.device]:
    """The devices an entry point's --device names.  Under a process group
    (torchrun), this process's own device: cuda:LOCAL_RANK or the CPU.
    Otherwise one device ('cuda', the current GPU, 'cuda:N', 'cpu'), or a
    comma list of them, repeats allowed ('cuda:0,cuda:1' splits the rows over two GPUs;
    'cpu,cpu' is a data axis of two on one CPU).  Plain 'cuda' is one GPU
    even on a host with several: replicas on threads of one process
    measured slower than one device (PERF.md, Findings).  A GPU request is
    never answered with the CPU."""
    names = [n.strip() for n in name.split(",")]
    if distributed.is_initialized():
        if len(names) > 1:
            raise ValueError(f"--device {name!r}: under torchrun each "
                             "process drives one device")
        device = resolve_device(names[0])
        if device.type != "cuda":
            return [device]
        local = distributed.local_rank()
        if device.index is not None and device.index != local:
            raise ValueError(f"--device {name!r} differs from this "
                             f"process's GPU, cuda:{local} (LOCAL_RANK)")
        return [resolve_device(f"cuda:{local}")]
    devices = [resolve_device(n) for n in names]
    # an index, which torch.cuda.set_device and the replicas' guards need
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices]


def make_mesh(num_devices: Optional[int] = None, num_partitions: int = 1,
              data_axis: str = "data", model_axis: str = "model",
              devices: Optional[Sequence[torch.device]] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A data axis over the first num_devices of `devices` (default: every
    visible GPU, as jax.devices()) and, with `group`, over that group's
    processes.  num_partitions > 1 raises NotImplementedError."""
    if num_partitions > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    devs = devs[:num_devices or len(devs)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if group is not None and len(devs) > 1:
        raise ValueError("a mesh over a process group holds one device "
                         "per process")
    return Mesh(devs, group, data_axis, model_axis)
