"""Listen, Attend and Spell, inference (counterpart of
automatic_speech_recognition_tpu/models/las.py).

- Listener 'cnn': 2 stride-2 SAME convs (time/4, feat/4) + ReLU, flatten
  (B, T, Dr, C) with C fastest, then N x {BiRNN -> proj -> BN -> ReLU}
  (an extra BN per layer and after each conv when cfg.apply_bn).  Lengths
  follow ceil_half twice.
- Speller: embedding, stacked tanh RNN cells, additive or location-aware
  attention whose query is the concat of ALL layer states in layer order,
  output dense.  Greedy: <SOS> (id 1) feeds the first step, states and the
  first alignment are zero, the argmax feeds the next step.

float32 only; 'pblstm', bf16 compute_cast and the training branch
(teacher forcing, scheduled sampling, dropout) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from automatic_speech_recognition_tpu.config import Config
from automatic_speech_recognition_tpu.utils.tokenizer import SOS_ID

from ..ops import attention as att
from ..ops import layers as L


def ceil_half(x):
    """(x + x % 2) / 2 — the reference's length reduction."""
    return (x + x % 2) // 2


def _check_supported(cfg: Config) -> None:
    if cfg.enc_type != "cnn":
        raise NotImplementedError(f"enc_type {cfg.enc_type!r}: only 'cnn' "
                                  "is ported")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"dtype {cfg.dtype!r}: only float32 is "
                                  "ported")


class ListenerLayer(nn.Module):
    def __init__(self, in_dim: int, units: int, apply_bn: bool):
        super().__init__()
        self.birnn = L.make_birnn(in_dim, units)
        self.proj = nn.Linear(2 * units, units)
        self.bn_extra = L.BatchNorm(units) if apply_bn else None
        self.bn_main = L.BatchNorm(units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(L.birnn_apply(self.birnn, x))
        if self.bn_extra is not None:
            x = self.bn_extra(x)
        return torch.relu(self.bn_main(x))


class Listener(nn.Module):
    """CNN listener: (B, T, D, 3) features -> (B, T', enc_units)."""

    def __init__(self, cfg: Config):
        super().__init__()
        C = cfg.num_enc_channels
        self.conv0 = nn.Conv2d(3, C, 3, stride=2)
        self.conv1 = nn.Conv2d(C, C, 3, stride=2)
        self.bn_conv0 = L.BatchNorm(C) if cfg.apply_bn else None
        self.bn_conv1 = L.BatchNorm(C) if cfg.apply_bn else None
        d = ceil_half(ceil_half(cfg.feat_dim)) * C
        self.layers = nn.ModuleList()
        for _ in range(cfg.num_enc_layers):
            self.layers.append(ListenerLayer(d, cfg.enc_units, cfg.apply_bn))
            d = cfg.enc_units

    def forward(self, audio: torch.Tensor, audiolen: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = audio                                   # NHWC, 3 channels
        for conv, bn in ((self.conv0, self.bn_conv0),
                         (self.conv1, self.bn_conv1)):
            x = L.conv2d_apply(x, conv.weight, conv.bias, stride=2)
            if bn is not None:
                x = bn(x)
            x = torch.relu(x)
            audiolen = ceil_half(audiolen)
        B, T, Dr, C = x.shape
        x = x.reshape(B, T, Dr * C)
        for layer in self.layers:
            x = layer(x)
        return x, audiolen


class Speller(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        h_dim = cfg.enc_units                     # cnn listener width
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.embedding_size)
        self.attention = att.Attention(
            cfg.mode, h_dim, cfg.dec_units * cfg.num_dec_layers,
            cfg.attention_size, cfg.loc_kernel_size, cfg.loc_num_channels)
        self.out = nn.Linear(cfg.dec_units, cfg.vocab_size)
        in_dim = cfg.embedding_size + h_dim
        self.cells = nn.ModuleList()
        for _ in range(cfg.num_dec_layers):
            self.cells.append(nn.Linear(in_dim + cfg.dec_units,
                                        cfg.dec_units))
            in_dim = cfg.dec_units
        # trained with joint CTC; greedy attention decoding does not read it
        self.ctc_head = (nn.Linear(h_dim, cfg.vocab_size + 1) if cfg.ctc
                         else None)


def decode_step(sp: Speller, enc_out, enc_len, states, prev_emb, prev_align,
                h_proj=None):
    """One decoder step.  states: (L, B, U).  Returns (logits, new states,
    alphas)."""
    B = enc_out.shape[0]
    s_i = states.transpose(0, 1).reshape(B, -1)
    context, alphas = sp.attention(enc_out, s_i, prev_align, enc_len, h_proj)
    x = torch.cat([prev_emb, context], -1)
    new_states = []
    for l, cell in enumerate(sp.cells):
        x = L.rnn_cell_apply(cell, x, states[l])
        new_states.append(x)
    return sp.out(x), torch.stack(new_states), alphas


def speller_greedy(sp: Speller, enc_out, enc_len, dec_steps: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy argmax feedback for dec_steps.  Returns logits (B, steps, V)
    and alphas (B, steps, T_enc)."""
    B, T_enc, _ = enc_out.shape
    emb = L.embedding_lookup(
        sp.embedding.weight,
        torch.full((B,), SOS_ID, dtype=torch.long, device=enc_out.device))
    states = enc_out.new_zeros(len(sp.cells), B, sp.out.in_features)
    align = enc_out.new_zeros(B, T_enc)
    h_proj = att.precompute_hidden(sp.attention, enc_out)
    logits, alphas = [], []
    for _ in range(dec_steps):
        lg, states, align = decode_step(sp, enc_out, enc_len, states, emb,
                                        align, h_proj)
        emb = L.embedding_lookup(sp.embedding.weight, lg.argmax(-1))
        logits.append(lg)
        alphas.append(align)
    return torch.stack(logits, 1), torch.stack(alphas, 1)


class LAS(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        _check_supported(cfg)
        self.listener = Listener(cfg)
        self.speller = Speller(cfg)

    def forward(self, audio: torch.Tensor, audiolen: torch.Tensor,
                dec_steps: int):
        """Greedy inference.  Returns (logits, alphas, enc_len)."""
        enc_out, enc_len = self.listener(audio, audiolen)
        logits, alphas = speller_greedy(self.speller, enc_out, enc_len,
                                        dec_steps)
        return logits, alphas, enc_len


@torch.no_grad()
def init(cfg: Config, generator: torch.Generator,
         device: torch.device) -> LAS:
    """A LAS with the JAX package's init distributions: glorot-uniform
    dense layers and RNN cells (over the fused [x, h] kernel), uniform +-1
    embedding and u, conv N(0, 1) * 0.01 with bias 0.01, location conv
    uniform +-sqrt(6 / (K + K C)), BN scale 1 / bias 0 / mean 0 / var 1,
    biases 0.  `generator` is a CPU generator."""
    model = LAS(cfg)
    g = generator
    for m in model.modules():
        if isinstance(m, nn.Linear):
            L.glorot_uniform_(m.weight, m.in_features, m.out_features, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.RNN):
            fan_in, fan_out = m.input_size + m.hidden_size, m.hidden_size
            for name, w in m.named_parameters():
                if name.startswith("weight"):
                    L.glorot_uniform_(w, fan_in, fan_out, g)
                else:
                    w.zero_()
        elif isinstance(m, nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.01)
            m.bias.fill_(0.01)
        elif isinstance(m, nn.Embedding):
            m.weight.uniform_(-1.0, 1.0, generator=g)
    a = model.speller.attention
    a.u.uniform_(-1.0, 1.0, generator=g)
    if a.mode == "loc":
        C, _, K = a.conv_w.shape
        limit = math.sqrt(6.0 / (K + K * C))
        a.conv_w.uniform_(-limit, limit, generator=g)
        a.conv_b.zero_()
    return model.to(device).eval()
