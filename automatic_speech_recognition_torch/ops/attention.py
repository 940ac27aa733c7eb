"""Additive (Bahdanau) and location-aware (Chorowski) attention
(counterpart of automatic_speech_recognition_tpu/ops/attention.py).

- masked softmax: energies at positions beyond seqlen are -1e8, so an
  all-masked row (seqlen 0) gets a uniform alignment, never NaN;
- additive: energy = u . tanh(h W_h + s W_s), u ~ Uniform(-1, 1);
- location-aware: adds f W_f, f = SAME 1-D cross-correlation of the
  previous alignment (1 -> C channels, kernel K, plus conv_b).  The JAX
  package evaluates f as a Toeplitz matmul for the TPU's sake; here it is
  F.conv1d with the kernel stored as (C, 1, K), the same math.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers

NEG_INF = -1e8


def masked_attend(hidden: torch.Tensor, energy: torch.Tensor,
                  seqlen: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Length mask, softmax over T, context = sum_t alpha_t h_t."""
    mask = layers.length_mask(seqlen, hidden.shape[1], energy.dtype)
    energy = energy.masked_fill(mask == 0, NEG_INF)
    alphas = torch.softmax(energy, dim=-1)
    context = torch.bmm(alphas[:, None, :], hidden)[:, 0]
    return context, alphas


class Attention(nn.Module):
    """Parameters of mode 'add' (w_h, w_s, u) or 'loc' (plus w_f, conv_w,
    conv_b), named as in the JAX pytree."""

    def __init__(self, mode: str, h_dim: int, s_dim: int, att_size: int,
                 kernel_size: int = 201, num_channels: int = 10):
        super().__init__()
        if mode not in ("add", "loc"):
            raise NotImplementedError(f"attention mode {mode}")
        self.mode = mode
        self.w_h = nn.Linear(h_dim, att_size, bias=False)
        self.w_s = nn.Linear(s_dim, att_size, bias=False)
        self.u = nn.Parameter(torch.empty(att_size))
        if mode == "loc":
            self.w_f = nn.Linear(num_channels, att_size, bias=False)
            self.conv_w = nn.Parameter(
                torch.empty(num_channels, 1, kernel_size))
            self.conv_b = nn.Parameter(torch.zeros(num_channels))

    def forward(self, hidden, state, align, seqlen, h_proj=None):
        if self.mode == "add":
            return additive_apply(self, hidden, state, align, seqlen, h_proj)
        return location_apply(self, hidden, state, align, seqlen, h_proj)


def precompute_hidden(p: Attention, hidden: torch.Tensor) -> torch.Tensor:
    """hidden @ W_h, fixed while decoding: callers hoist it out of the
    step loop."""
    return p.w_h(hidden)


def additive_apply(p: Attention, hidden, state, align, seqlen,
                   h_proj: Optional[torch.Tensor] = None):
    """align is unused (interface parity with location_apply)."""
    if h_proj is None:
        h_proj = precompute_hidden(p, hidden)
    v = torch.tanh(h_proj + p.w_s(state)[:, None, :])
    return masked_attend(hidden, v @ p.u, seqlen)


def location_features(p: Attention, align: torch.Tensor) -> torch.Tensor:
    """(B, T) previous alignment -> (B, T, C): SAME conv1d + conv_b."""
    K = p.conv_w.shape[-1]
    low = (K - 1) // 2                          # XLA SAME: low = (K-1)//2
    f = F.conv1d(F.pad(align[:, None, :], (low, K - 1 - low)), p.conv_w,
                 p.conv_b)
    return f.transpose(1, 2)


def location_apply(p: Attention, hidden, state, align, seqlen,
                   h_proj: Optional[torch.Tensor] = None):
    if h_proj is None:
        h_proj = precompute_hidden(p, hidden)
    v = torch.tanh(h_proj + p.w_s(state)[:, None, :]
                   + p.w_f(location_features(p, align)))
    return masked_attend(hidden, v @ p.u, seqlen)
