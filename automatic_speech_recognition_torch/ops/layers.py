"""Layer functions in plain PyTorch (counterpart of
automatic_speech_recognition_tpu/ops/layers.py), inference only.

Weights are in PyTorch's layouts (Linear (out, in), Conv2d OIHW, nn.RNN);
JAX's dense_apply is nn.Linear.  Activations keep the JAX package's
layouts, so conv2d_apply takes and returns NHWC.  The semantics kept on
purpose:

- the reference's "lstm" cells are vanilla tanh RNN cells,
  h' = tanh([x, h] @ W + b) with one bias;
- the bidirectional RNN's backward direction runs over the full padded
  sequence reversed (no sequence lengths), as nn.RNN does unpacked;
- conv2d: 3x3, stride 2, TF 'SAME' padding, which pads (0, 1) on an even
  length and (1, 1) on an odd one;
- batch norm at inference: (x - mean) * rsqrt(var + 1e-3) * scale + bias
  over the last axis, from the stored moving statistics.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def glorot_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return weight.uniform_(-limit, limit, generator=generator)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup (no variational noise: inference)."""
    return F.embedding(ids, table)


def rnn_cell_apply(cell: nn.Linear, x: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Vanilla tanh RNN cell, one fused Linear over [x, h]."""
    return torch.tanh(cell(torch.cat([x, h], -1)))


def make_birnn(in_dim: int, units: int) -> nn.RNN:
    """Bidirectional tanh RNN.  The JAX cell's single bias is bias_ih;
    bias_hh stays zero."""
    return nn.RNN(in_dim, units, nonlinearity="tanh", batch_first=True,
                  bidirectional=True)


def birnn_apply(rnn: nn.RNN, xs: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2U) = [forward | backward] outputs."""
    out, _ = rnn(xs)
    return out


def same_padding(n: int, k: int, stride: int) -> Sequence[int]:
    """TF 'SAME' (before, after) padding of one spatial axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 stride: int = 2) -> torch.Tensor:
    """NHWC conv with an OIHW weight, TF 'SAME' padding, no activation."""
    kh, kw = weight.shape[2:]
    th, tw = same_padding(x.shape[1], kh, stride)
    wh, ww = same_padding(x.shape[2], kw, stride)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (wh, ww, th, tw)), weight,
                 bias, stride=stride)
    return y.permute(0, 2, 3, 1)


def bn_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor,
             eps: float = 1e-3) -> torch.Tensor:
    """Inference batch norm over the last axis."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def length_mask(lengths: torch.Tensor, padded_len: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) -> (B, T) 1/0 mask: position p (1-based) is kept if p <= len."""
    pos = torch.arange(1, padded_len + 1, device=lengths.device)[None, :]
    return (pos <= lengths[:, None].to(torch.int64)).to(dtype)


class BatchNorm(nn.Module):
    """tf.layers.batch_normalization state: scale/bias parameters and
    mean/var moving statistics, applied at inference."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_apply(x, self.scale, self.bias, self.mean, self.var)
