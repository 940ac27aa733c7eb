"""Int8 weight-only quantization of the decoder for inference (counterpart
of automatic_speech_recognition_tpu/ops/quant.py).

Symmetric per-output-channel int8: scale = max|w| / 127 per output unit
(1.0 where the unit's weights are all zero), q = round-half-to-even(w /
scale) clipped to +-127, zero-point 0.  `QuantLinear` holds q (int8, in
nn.Linear's (out, in) layout, so the channel axis is JAX's last one
flipped to the first), the float32 scale `w_scale` and the float bias; it
computes (x @ q) * scale + b, scaling the (B, out) result and not the
weights, as the JAX package does.

Quantized: the speller's recurrent cells always, its output layer from a
vocabulary of 512 on; a fusion LM's rnn / lstm cells.  Attention, the
listener, the CTC head, a GRU LM and the LM's softmax stay float.  A
quantized model is for inference only: training/checkpoint.py refuses to
save one.

On the card this is a memory option, not a speed one: eager PyTorch
materializes q.to(x.dtype) at every call, so the bytes read per decoder
step do not fall as they do where XLA fuses the convert into the matmul.
"""

from __future__ import annotations

import copy
from typing import Dict, Union

import torch
from torch import nn

# -127..127 keeps the code symmetric (-128 would bias the dequantized mean)
_QMAX = 127.0
# output layers below this vocabulary stay float: the char vocabulary's is
# a rounding error next to the cells, and its logits feed beam log-probs
_OUT_QUANT_MIN_VOCAB = 512


def quantize_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(out, in) float weight -> {'q': int8 (out, in), 'scale': float32
    (out,)}: the JAX package's quantize_matrix of w.T, transposed."""
    w = w.detach().to(torch.float32)
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None]), -_QMAX, _QMAX)
    return {"q": q.to(torch.int8), "scale": scale}


def dequant_matmul(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(q): the matmul in x's dtype, then the per-channel scale
    on the (B, out) result."""
    return (x @ q.to(x.dtype).T) * scale.to(x.dtype)


class QuantLinear(nn.Module):
    """nn.Linear with int8 weights: buffers q (out, in) int8 and w_scale
    (out,) float32, and the float bias as a parameter."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        qd = quantize_matrix(linear.weight)
        self.register_buffer("q", qd["q"])
        self.register_buffer("w_scale", qd["scale"])
        self.bias = (nn.Parameter(linear.bias.detach().clone(),
                                  requires_grad=False)
                     if linear.bias is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dequant_matmul(x, self.q, self.w_scale)
        return y + self.bias if self.bias is not None else y


Dense = Union[nn.Linear, QuantLinear]


def quantize_speller(speller: nn.Module, vocab_size: int) -> nn.Module:
    """In place: the speller's cells, and `out` from a vocabulary of 512
    on, become QuantLinear."""
    for i, cell in enumerate(speller.cells):
        speller.cells[i] = QuantLinear(cell)
    if vocab_size >= _OUT_QUANT_MIN_VOCAB:
        speller.out = QuantLinear(speller.out)
    return speller


def quantize_model(model: nn.Module, vocab_size: int) -> nn.Module:
    """A copy of a float LAS with its speller quantized; the listener (a
    one-shot batched forward, not a per-step weight stream) stays
    float."""
    out = copy.deepcopy(model)
    quantize_speller(out.speller, vocab_size)
    return out


def quantize_lm(lm: nn.Module, lm_cfg) -> nn.Module:
    """A copy of a fusion char-RNNLM with its rnn / lstm cells quantized;
    a GRU LM comes back as it is, and the softmax stays float."""
    if lm_cfg.model == "gru":
        return lm
    out = copy.deepcopy(lm)
    for i, cell in enumerate(out.cells):
        out.cells[i] = QuantLinear(cell)
    return out


def maybe_quantize(model: nn.Module, cfg) -> nn.Module:
    """cfg.quantize_decoder applied to a restored float model: 'none' is
    the identity, 'int8' quantize_model, anything else raises."""
    mode = cfg.quantize_decoder
    if mode == "none":
        return model
    if mode != "int8":
        raise ValueError(
            f"--quantize_decoder must be 'none' or 'int8', got {mode!r}")
    return quantize_model(model, cfg.vocab_size)


def size_bytes(module: nn.Module) -> int:
    """Bytes of the module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values())
