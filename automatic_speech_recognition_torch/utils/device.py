"""Device selection (the role utils/platform.py plays in the JAX package)."""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The torch.device for `name`.  A CUDA device that is not present
    raises: a GPU request is never answered with the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not "
                               "available on this host")
        if device.index is not None \
                and device.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are visible")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device


def split_device(argv: Optional[Sequence[str]]) -> Tuple[str, List[str]]:
    """--device (default cuda) apart from the repository CLIs' own flags."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    return ns.device, rest


def disable_tf32() -> None:
    """float32 means float32: no TF32 in CUDA matmuls or cuDNN
    convolutions; and bfloat16 matmuls sum in float32, as the TPU's
    matrix unit does, without cuBLAS's reduced-precision reductions (the
    CLIs' setting on a GPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """A host batch array as a CPU tensor.  The loader feeds
    ml_dtypes.bfloat16 under --dtype bfloat16, which torch.from_numpy
    refuses: its bits go through a uint16 view into torch.bfloat16,
    unchanged."""
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)
