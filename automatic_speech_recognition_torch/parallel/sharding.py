"""Parameter and batch layouts over a (data, model) mesh (counterpart of
automatic_speech_recognition_tpu/parallel/sharding.py).

The JAX package's rule, param_spec: a leaf of two or more axes whose last
(output) axis divides by the model axis, at twice its size or more, is
split along that axis (column parallelism); everything else, biases, BN,
`u`, conv_b and scalars, is replicated, and Adam's moments follow their
parameters.  Here the rule is decided on the JAX leaf
(models/convert.split_dims, which pairs every port tensor with its leaf)
and carried to the port's layout: dim 0 of a Linear, Conv2d, nn.RNN or
location-conv weight, dim 1 of the embedding table.  The split layers'
arithmetic is parallel/tensor_parallel.py's.

- Training (one process per GPU under torchrun): place_state keeps this
  rank's rows of every split parameter, Adam moment and MultiSteps
  accumulator; whole_state_dict / whole_optimizer_state gather them back
  (every rank of the model group takes part) and load_whole_state_dict /
  slice_optimizer_state cut a whole checkpoint to a rank's shard, so a
  checkpoint is whole and independent of num_partitions.
- Evaluation (one process over a device list): place_eval_params makes a
  replica per run of num_partitions devices, its weights (and the fusion
  LM's) split over them; a batch's rows are padded to a multiple of the
  replicas (pad_batch_to), split into equal chunks, one per replica, each
  run on a thread of its own, and gathered back in row order.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import host_tensor
from . import tensor_parallel as tp
from .mesh import Mesh


def param_spec(shape: Sequence[int], model_size: int) -> Optional[int]:
    """The JAX package's param_spec on a JAX leaf's shape: the axis split
    over a model axis of model_size (its last), or None: replicated."""
    shape = tuple(shape)
    if (model_size > 1 and len(shape) >= 2
            and shape[-1] % model_size == 0 and shape[-1] >= 2 * model_size):
        return len(shape) - 1
    return None


def param_specs(model: nn.Module, model_size: int) -> Dict[str, int]:
    """Port tensor name -> split dim, for a LAS or a CharRNN (int8 ones
    included), by param_spec on each JAX leaf."""
    # imported here: models/convert imports the language model, whose
    # directory I/O imports training/, which imports this module
    from ..models import convert
    return convert.split_dims(model, model_size)


def state_shardings(model: nn.Module) -> List[Optional[int]]:
    """For each trainable parameter of a (split) model, in the
    optimizer's order, the dim it, its Adam moments and its MultiSteps
    accumulator are split along, or None."""
    dims = tp.layout(model)
    return [dims.get(n) for n, p in model.named_parameters()
            if p.requires_grad]


def shard_model(model: nn.Module, axis: tp.ModelAxis) -> nn.Module:
    """Split `model` (a whole LAS or CharRNN) over `axis` in place."""
    return tp.shard_(model, param_specs(model, axis.size), axis)


def place_state(mesh: Mesh, ts):
    """A whole TrainState cut to this rank's shard over the mesh's model
    group, in place, and returned: the split parameters keep their rows,
    Adam's moments and the MultiSteps accumulator follow them, counters
    and generators stay as they are."""
    from ..training.trainer import make_optimizer   # trainer imports us
    whole = ts.optimizer.state_dict()
    shard_model(ts.model, tp.GroupAxis(mesh.model_group))
    ts.optimizer = make_optimizer(ts.model, ts.optimizer.cfg)
    ts.optimizer.load_state_dict(slice_optimizer_state(ts.model, whole))
    return ts


@torch.no_grad()
def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """model.state_dict() with every split tensor gathered whole (a
    collective over the model group: every rank of it calls this)."""
    sd = model.state_dict()
    for name in tp.layout(model):
        owner, _, leaf = name.rpartition(".")
        m = model.get_submodule(owner)
        sd[name] = tp.full(m, leaf).detach()
        for j in range(1, m.tp_axis.local):
            del sd[f"{name}_tp{j}"]
    return sd


def load_whole_state_dict(model: nn.Module,
                          state: Dict[str, torch.Tensor]) -> None:
    """Load a whole state dict into a (split) model: each split tensor
    takes its parts of the whole one."""
    state = dict(state)
    for name, dim in tp.layout(model).items():
        m = model.get_submodule(name.rpartition(".")[0])
        for j, part in enumerate(m.tp_axis.split(state[name], dim)):
            state[name if j == 0 else f"{name}_tp{j}"] = part
    model.load_state_dict(state)


def _map_optimizer_state(model: nn.Module, state: Dict,
                         fn: Callable[[torch.Tensor, int], torch.Tensor]
                         ) -> Dict:
    """trainer.Optimizer.state_dict() with fn(tensor, dim) applied to the
    moments and accumulator of every split parameter."""
    dims = state_shardings(model)
    if all(d is None for d in dims):
        return state
    adam = dict(state["adam"])
    adam["state"] = {
        i: {k: (fn(v, dims[i]) if dims[i] is not None and torch.is_tensor(v)
                and v.dim() > 0 else v) for k, v in s.items()}
        for i, s in state["adam"]["state"].items()}
    acc = state["acc"]
    if acc is not None:
        acc = [a if d is None else fn(a, d) for a, d in zip(acc, dims)]
    return {**state, "adam": adam, "acc": acc}


@torch.no_grad()
def whole_optimizer_state(model: nn.Module, state: Dict) -> Dict:
    """A split model's optimizer state with Adam's moments and the
    MultiSteps accumulator gathered whole (a collective, as
    whole_state_dict)."""
    axis = tp.model_axis(model)
    return _map_optimizer_state(model, state,
                                lambda t, d: axis.full([t], d).detach())


def slice_optimizer_state(model: nn.Module, state: Dict) -> Dict:
    """A whole optimizer state cut to a split model's rows."""
    axis = tp.model_axis(model)
    return _map_optimizer_state(model, state,
                                lambda t, d: axis.split(t, d)[0].clone())


@dataclass
class Replica:
    """A model (and fusion LM) on one device of the mesh, or split over a
    run of num_partitions devices, `device` the first."""
    device: torch.device
    model: nn.Module
    lm: Optional[nn.Module] = None


def pad_batch_to(n: int, multiple: int) -> int:
    """Rows a batch must be padded to so dim 0 splits evenly."""
    return -(-n // max(multiple, 1)) * max(multiple, 1)


def place_eval_params(mesh: Mesh, model: nn.Module,
                      lm: Optional[nn.Module] = None) -> List[Replica]:
    """One replica per run of num_partitions devices of the mesh, in eval
    mode.  With a model axis of 1, `model` (and `lm`) itself on the first
    device and copies on the others; otherwise copies, each split over
    its devices by param_specs (BN statistics, biases and the other
    whole tensors on the first)."""
    replicas = []
    for i, devs in enumerate(mesh.replica_devices()):
        whole = i == 0 and len(devs) == 1
        m, l = (model, lm) if whole else (copy.deepcopy(model),
                                          copy.deepcopy(lm))
        m = m.to(devs[0]).eval()
        l = l.to(devs[0]).eval() if l is not None else None
        if len(devs) > 1:
            axis = tp.DeviceAxis(devs)
            shard_model(m, axis)
            if l is not None:
                shard_model(l, axis)
        replicas.append(Replica(devs[0], m, l))
    return replicas


def place_data_batch(mesh: Mesh, arrays: Sequence[Any]
                     ) -> List[Tuple[torch.Tensor, ...]]:
    """Each replica's chunk of rows of every array (tensors or NumPy
    arrays), on the replica's first device.  dim 0 must divide by the
    data axis (the replicas)."""
    devices = [devs[0] for devs in mesh.replica_devices()]
    n = len(devices)
    B = arrays[0].shape[0]
    if B % n:
        raise ValueError(f"{B} rows do not split over {n} replicas; pad "
                         "with pad_batch_to first")
    rows = B // n
    tensors = [host_tensor(a) if isinstance(a, np.ndarray) else a
               for a in arrays]
    return [tuple(t[i * rows:(i + 1) * rows].to(dev) for t in tensors)
            for i, dev in enumerate(devices)]


def gather_rows(outputs: Sequence[Any], device: torch.device) -> Any:
    """The replicas' outputs joined along dim 0 in row order on `device`:
    tensors, or tuples / NamedTuples of them, whose int fields (a beam
    search's step count) take the largest."""
    first = outputs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outputs])
    if isinstance(first, int):
        return max(outputs)
    fields = [gather_rows(list(xs), device) for xs in zip(*outputs)]
    return (type(first)(*fields) if hasattr(first, "_fields")
            else type(first)(fields))


def _on_device(device: torch.device, fn: Callable, *args):
    guard = (torch.cuda.device(device) if device.type == "cuda"
             else contextlib.nullcontext())
    with guard:
        return fn(*args)


def run_replicas(mesh: Mesh, replicas: Sequence[Replica], fn: Callable,
                 arrays: Sequence[Any]) -> Any:
    """fn(replica, *its chunk of arrays) on every replica at once, one
    thread each, gathered in row order on the first device.  One replica
    runs inline on the whole batch."""
    chunks = place_data_batch(mesh, arrays)
    if len(replicas) == 1:
        return _on_device(replicas[0].device, fn, replicas[0], *chunks[0])
    with ThreadPoolExecutor(len(replicas),
                            thread_name_prefix="replica") as pool:
        futures = [pool.submit(_on_device, r.device, fn, r, *c)
                   for r, c in zip(replicas, chunks)]
        outputs = [f.result() for f in futures]
    return gather_rows(outputs, mesh.devices[0])
