"""Device selection (the role utils/platform.py plays in the JAX package)."""

from __future__ import annotations

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
