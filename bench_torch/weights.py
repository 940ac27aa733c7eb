"""Seeded weights for a configuration, made on the device in a few large
draws, keyed by the program's state-dict names (the spec comes from the
configuration's reference module, its `param_spec`)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(spec: List[Tuple[str, tuple, tuple]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """Every tensor of `spec` (name, shape, init), float32 on `device`:
    glorot-uniform matrices, uniform embedding and attention vector,
    normal conv kernels, constant biases and statistics, as the recipe
    initializes them.  One uniform and one normal draw cover all."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(math.prod(s) for _, s, i in spec if i[0] in ("glorot", "uniform"))
    n_norm = sum(math.prod(s) for _, s, i in spec if i[0] == "normal")
    uni = torch.rand(n_uni, generator=g, device=device) * 2.0 - 1.0
    nrm = torch.randn(max(n_norm, 1), generator=g, device=device)
    out, a, b = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "glorot":
            limit = math.sqrt(6.0 / (init[1] + init[2]))
            out[name] = (uni[a:a + n] * limit).view(shape)
            a += n
        elif init[0] == "uniform":
            out[name] = (uni[a:a + n] * init[1]).view(shape)
            a += n
        elif init[0] == "normal":
            out[name] = (nrm[b:b + n] * init[1]).view(shape)
            b += n
        else:
            out[name] = torch.full(shape, float(init[1]), device=device)
    return out
