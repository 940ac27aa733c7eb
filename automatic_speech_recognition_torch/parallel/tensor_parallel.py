"""Column-parallel layers: the collectives GSPMD inserts around the JAX
package's tensor-parallel layout, written out.

No module of the JAX package corresponds to this one.  There,
parallel/sharding.param_spec splits a weight's last (output) axis over
the mesh's 'model' axis, make_mesh_train_step jits one SPMD program, and
XLA adds the gathers and reductions the shardings imply.  Here each
position of the model axis holds its own rows of every split weight
(parallel/sharding.py decides which, by param_spec on the JAX leaf), and
a split layer is explicit:

- each position computes its own output columns from the whole input;
- `gather` joins the columns, so every position holds the whole
  activation and everything downstream of the layer stays replicated and
  unchanged (a replicated bias is added after the gather);
- a cuDNN RNN takes its whole weight matrices: `full` gathers them.

A ModelAxis is where the positions live:

- GroupAxis: one position per process of a model group (training under
  torchrun), through three autograd Functions: copy_to_model (identity
  forward; the backward sums the input's gradient over the group, since
  each position saw only its columns' share of it), gather_from_model
  (all-gather forward; the backward keeps this position's slice of the
  gathered output's gradient, which every position computed whole) and
  gathered_weight (the same gather, for a weight: the backward keeps this
  position's slice of the whole weight's gradient).
- DeviceAxis: every position in this process, on a device of its own
  (inference only, no autograd): the input is copied to each device and
  the gathers are torch.cat of the per-device outputs on the replica's
  first device.

The collectives are all_gather's list form and all_reduce only (gloo has
no reduce_scatter, and its all_gather_into_tensor depends on the
version), with their buffers where the backend wants them
(distributed.comm_device), so gloo ranks, on the CPU or sharing one card,
run the code NCCL runs.

A split module carries `tp_axis` (its ModelAxis) and `tp_dims` (tensor
name -> split dim); on a DeviceAxis the parts beyond the first are
registered beside it as `<name>_tp<j>` (on device j), so
models/las.compute_cast casts them with the rest.  nn.Linear and int8
QuantLinear modules become ColumnLinear / ColumnQuantLinear; the other
split layers (conv, BiRNN, embedding, location conv) are the layer
functions' business (ops/layers.py, ops/attention.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantLinear, dequant_matmul
from . import distributed


def _all_gather(x: torch.Tensor, group: dist.ProcessGroup
                ) -> List[torch.Tensor]:
    """Every position's x (one shape on all), in group-rank order, on x's
    device."""
    buf = x.detach().contiguous().to(distributed.comm_device())
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    return [t.to(x.device) for t in out]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return distributed.reduced(grad, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group: dist.ProcessGroup):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), \
            None, None


def copy_to_model(x: torch.Tensor, group: dist.ProcessGroup
                  ) -> torch.Tensor:
    """x itself; its gradient is summed over the model group."""
    return _CopyToModel.apply(x, group)


def gather_from_model(y_local: torch.Tensor, dim: int,
                      group: dist.ProcessGroup) -> torch.Tensor:
    """The positions' y_local joined along dim in group order; the
    gradient reaching y_local is this position's slice of the whole."""
    return _GatherFromModel.apply(y_local, dim, group)


def gathered_weight(w_shard: torch.Tensor, dim: int,
                    group: dist.ProcessGroup) -> torch.Tensor:
    """The whole weight from the positions' rows along dim; its gradient
    (the same on every position, whose computation with it is
    replicated) reaches w_shard as this position's slice."""
    return _GatherFromModel.apply(w_shard, dim, group)


class ModelAxis:
    """The positions of a model axis that this process computes."""
    size: int                 # positions on the axis
    local: int                # positions in this process

    def split(self, t: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """This process's parts of a whole tensor along dim, each on its
        position's device (views where the device is the tensor's)."""
        raise NotImplementedError

    def scatter(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x as the input of each local position."""
        raise NotImplementedError

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The whole tensor from the local positions' parts along dim."""
        raise NotImplementedError

    def full(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """A whole weight from the local positions' rows along dim."""
        raise NotImplementedError

    def __deepcopy__(self, memo):
        return self              # a process group or devices: shared


def _part(t: torch.Tensor, dim: int, index: int, parts: int
          ) -> torch.Tensor:
    width = t.shape[dim] // parts
    return t.narrow(dim, index * width, width)


class GroupAxis(ModelAxis):
    """One position per process of a model group (training)."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.local = 1

    def split(self, t, dim):
        return [_part(t, dim, self.index, self.size)]

    def scatter(self, x):
        return [copy_to_model(x, self.group)]

    def gather(self, parts, dim):
        return gather_from_model(parts[0], dim, self.group)

    def full(self, parts, dim):
        return gathered_weight(parts[0], dim, self.group)


class DeviceAxis(ModelAxis):
    """Every position in this process, one device each (inference)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.size = self.local = len(self.devices)

    def split(self, t, dim):
        return [_part(t, dim, j, self.size).to(d)
                for j, d in enumerate(self.devices)]

    def scatter(self, x):
        return [x.to(d) for d in self.devices]

    def gather(self, parts, dim):
        return torch.cat([p.to(self.devices[0]) for p in parts], dim)

    full = gather


def axis_of(module: nn.Module) -> Optional[ModelAxis]:
    return getattr(module, "tp_axis", None)


def is_split(module: nn.Module, name: str) -> bool:
    return name in getattr(module, "tp_dims", {})


def parts(module: nn.Module, name: str) -> List[torch.Tensor]:
    """The local positions' parts of a split tensor of `module`."""
    return [getattr(module, name if j == 0 else f"{name}_tp{j}")
            for j in range(module.tp_axis.local)]


def column(module: nn.Module, fn: Callable, x: torch.Tensor,
           name: str = "weight", dim: int = -1) -> torch.Tensor:
    """fn(input, part) at every local position, gathered along dim: a
    column-parallel product of x with `module`'s split tensor `name`."""
    axis = module.tp_axis
    return axis.gather([fn(xi, w) for xi, w in
                        zip(axis.scatter(x), parts(module, name))], dim)


def full(module: nn.Module, name: str) -> torch.Tensor:
    """The whole of `module`'s tensor `name` (gathered when split)."""
    if not is_split(module, name):
        return getattr(module, name)
    return module.tp_axis.full(parts(module, name), module.tp_dims[name])


class ColumnLinear(nn.Linear):
    """nn.Linear whose output rows are split over a model axis;
    in_features and out_features stay the whole layer's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = column(self, F.linear, x)
        return y if self.bias is None else y + self.bias


class ColumnQuantLinear(QuantLinear):
    """QuantLinear whose int8 rows and their scales are split."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.tp_axis
        y = axis.gather([dequant_matmul(xi, q, s) for xi, q, s in zip(
            axis.scatter(x), parts(self, "q"), parts(self, "w_scale"))], -1)
        return y if self.bias is None else y + self.bias


_COLUMN = {nn.Linear: ColumnLinear, QuantLinear: ColumnQuantLinear}


@torch.no_grad()
def shard_(model: nn.Module, dims: Dict[str, int], axis: ModelAxis
           ) -> nn.Module:
    """Split `model`'s tensors named in dims (name -> dim) over `axis`, in
    place: each keeps this process's parts (copies, so the whole tensor
    can go), a parameter as a parameter with its requires_grad, a buffer
    as a buffer.  The tensors not named stay where they are."""
    for name, dim in dims.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        whole = getattr(owner, leaf)
        is_param = leaf in owner._parameters
        for j, part in enumerate(axis.split(whole, dim)):
            key = leaf if j == 0 else f"{leaf}_tp{j}"
            part = part.clone()
            if is_param:
                setattr(owner, key, nn.Parameter(
                    part, requires_grad=whole.requires_grad))
            else:
                owner.register_buffer(key, part)
        owner.tp_axis = axis
        owner.tp_dims = {**getattr(owner, "tp_dims", {}), leaf: dim}
        if type(owner) in _COLUMN:
            # the same module with a column-parallel forward; state dict
            # names, attributes and isinstance checks are unchanged
            owner.__class__ = _COLUMN[type(owner)]
    return model


def layout(model: nn.Module) -> Dict[str, int]:
    """Name -> split dim of every split tensor of `model` (empty when it
    is whole)."""
    out = {}
    for mname, m in model.named_modules():
        for leaf, dim in getattr(m, "tp_dims", {}).items():
            out[f"{mname}.{leaf}" if mname else leaf] = dim
    return out


def model_axis(model: nn.Module) -> Optional[ModelAxis]:
    """The axis `model` is split over, or None."""
    return next((m.tp_axis for m in model.modules()
                 if getattr(m, "tp_axis", None) is not None), None)
