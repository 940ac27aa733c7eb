"""Model replicas and row splits for evaluation over a data axis
(counterpart of automatic_speech_recognition_tpu/parallel/sharding.py with
a model axis of 1).

JAX places the parameters on every device of the mesh and the batch's
rows along 'data', and jit runs one program over them.  Here every device
of the mesh holds a replica of the model (its BN statistics, its int8
weights and the fusion LM travel with it), a batch's rows are split into
equal chunks, one per device, each chunk runs on its replica on a thread
of its own, and the results are gathered back in row order.  Callers pad
a batch to a multiple of the data axis first (pad_batch_to), as the
repository's test.py and decode.py do.  Not ported: param_spec and
state_shardings, the tensor-parallel rules (ROADMAP item 12).
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import host_tensor
from .mesh import Mesh


@dataclass
class Replica:
    """A model (and fusion LM) on one device of the mesh."""
    device: torch.device
    model: nn.Module
    lm: Optional[nn.Module] = None


def pad_batch_to(n: int, multiple: int) -> int:
    """Rows a batch must be padded to so dim 0 splits evenly."""
    return -(-n // max(multiple, 1)) * max(multiple, 1)


def place_eval_params(mesh: Mesh, model: nn.Module,
                      lm: Optional[nn.Module] = None) -> List[Replica]:
    """One replica per device of the mesh, in eval mode: `model` (and `lm`)
    itself on the first device, copies on the others."""
    replicas = []
    for i, dev in enumerate(mesh.devices):
        m, l = (model, lm) if i == 0 else (copy.deepcopy(model),
                                           copy.deepcopy(lm))
        replicas.append(Replica(dev, m.to(dev).eval(),
                                l.to(dev).eval() if l is not None else None))
    return replicas


def place_data_batch(mesh: Mesh, arrays: Sequence[Any]
                     ) -> List[Tuple[torch.Tensor, ...]]:
    """Each device's chunk of rows of every array (tensors or NumPy
    arrays), on that device.  dim 0 must divide by the data axis."""
    n = len(mesh.devices)
    B = arrays[0].shape[0]
    if B % n:
        raise ValueError(f"{B} rows do not split over {n} devices; pad "
                         "with pad_batch_to first")
    rows = B // n
    tensors = [host_tensor(a) if isinstance(a, np.ndarray) else a
               for a in arrays]
    return [tuple(t[i * rows:(i + 1) * rows].to(dev) for t in tensors)
            for i, dev in enumerate(mesh.devices)]


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
