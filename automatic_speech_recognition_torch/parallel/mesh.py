"""The (data, model) mesh (counterpart of
automatic_speech_recognition_tpu/parallel/mesh.py).

JAX builds a ('data', 'model') jax.sharding.Mesh over every device,
reshaped (n / num_partitions, num_partitions), and lets GSPMD split the
batch over 'data' and the parameters over 'model' (parallel/sharding.py's
param_spec).  Here a Mesh lists the devices this process drives and the
process group that extends it over other processes:

- evaluation runs in one process over a device list: consecutive runs of
  num_partitions devices hold one replica of the model each, its weights
  split column-wise over them, and a batch's rows go over the replicas;
- training runs one process per GPU under torchrun: the mesh holds this
  process's device, the group of all of them, and this rank's place on
  the (data, model) grid (distributed.model_grid), rank r at
  divmod(r, num_partitions).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import distributed

log = logging.getLogger(__name__)


@dataclass
class Mesh:
    """`devices`: this process's devices, in the mesh's order; `group`:
    the processes the mesh spans (None: this one); `num_partitions`: the
    model axis; `grid`: this rank's place on a process group's (data,
    model) grid (None in one process).  `shape`: axis name -> size, as
    jax's Mesh.shape; `size`: every device of the mesh."""
    devices: List[torch.device]
    group: Optional[dist.ProcessGroup]
    data_axis: str = "data"
    model_axis: str = "model"
    num_partitions: int = 1
    grid: Optional[distributed.Grid] = None

    @property
    def shape(self) -> Dict[str, int]:
        n = (dist.get_world_size(self.group) if self.group
             else len(self.devices))
        return {self.data_axis: n // self.num_partitions,
                self.model_axis: self.num_partitions}

    @property
    def size(self) -> int:
        return self.shape[self.data_axis] * self.num_partitions

    @property
    def data_group(self) -> distributed.Group:
        """The processes this rank's data-parallel sums run over."""
        return self.grid.data_group if self.grid else None

    @property
    def model_group(self) -> distributed.Group:
        """The processes this rank's model columns are gathered from."""
        return self.grid.model_group if self.grid else None

    @property
    def data_index(self) -> int:
        return self.grid.data_index if self.grid else 0

    def replica_devices(self) -> List[List[torch.device]]:
        """In one process, each model replica's devices: consecutive runs
        of num_partitions (mesh.py:36's reshape)."""
        k = self.num_partitions
        return [self.devices[i:i + k] for i in range(0, len(self.devices), k)]


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
    """A (data, model) mesh over the first num_devices of `devices`
    (default: every visible GPU, as jax.devices()), model axis
    num_partitions; with `group` (the world), over that group's
    processes, one device each, where num_partitions must divide the
    processes on one host (LOCAL_WORLD_SIZE), so that a model group stays
    within a host, as train.py's check that it stays within a process.
    A device or process count that num_partitions does not divide raises
    ValueError."""
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    devs = devs[:num_devices or len(devs)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if group is None:
        if len(devs) % num_partitions:
            raise ValueError(f"{len(devs)} devices not divisible by "
                             f"{num_partitions} partitions")
        return Mesh(devs, None, data_axis, model_axis, num_partitions)
    if len(devs) > 1:
        raise ValueError("a mesh over a process group holds one device "
                         "per process")
    local = distributed.local_world_size()
    if local % num_partitions:
        raise ValueError(
            f"num_partitions {num_partitions} must divide the processes "
            f"on one host ({local}, LOCAL_WORLD_SIZE) so each "
            "model-parallel group stays within one host")
    return Mesh(devs, group, data_axis, model_axis, num_partitions,
                distributed.model_grid(num_partitions))


def eval_mesh(name: str, num_partitions: int = 1, data_axis: str = "data",
              model_axis: str = "model") -> Mesh:
    """The mesh an evaluation entry point (test, decode, the Recognizer)
    runs on: the devices --device names (devices_for), each run of
    num_partitions of them holding a replica split over them.  Under
    torchrun every process evaluates on its own device with the model
    whole, as the JAX package's multi-process path keeps the
    process-local path (test.py:94-99): num_partitions is logged and set
    aside there, and no model-axis collective runs."""
    if num_partitions > 1 and distributed.is_initialized():
        log.info("--num_partitions %d under torchrun: each process "
                 "evaluates with the model replicated on its own device",
                 num_partitions)
        num_partitions = 1
    return make_mesh(num_partitions=num_partitions, data_axis=data_axis,
                     model_axis=model_axis, devices=devices_for(name))
