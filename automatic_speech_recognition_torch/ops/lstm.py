"""The listener's BiLSTM as one autograd.Function: nn.LSTM's function,
unpacked (gates i, f, g, o; zero initial states; the reverse direction over
the whole padded sequence reversed; float32 throughout).

The Function runs x W_ih^T + b for both directions at once, the time
recurrence (the product with W_hh, the gate non-linearities and the cell
update) and, in its backward, the recurrence's gradient, then the input
gradient and the weight gradients as plain large products.  The
recurrence is the hand-written kernel pair of csrc/lstm_recurrence.cu for
a CUDA tensor (`recurrence_forward` / `recurrence_backward`, which raise
on what the kernels do not take), and the same arithmetic written out in
PyTorch for a CPU tensor (`plain_forward` / `plain_backward`), which the
tests hold to nn.LSTM and autograd.

What it saves for the backward: the input, the activated gates (B, T, 8U,
written over the input projection), the cell states and the output (B, T,
2U each; the output, which the layer after keeps anyway, gives each
step's h_prev for W_hh's gradient), the place of cuDNN's reserve.

`route` says which path a BiRNN takes (ops/layers.birnn_apply): an
nn.LSTM in float32 (or float64 on the CPU) takes BiLSTM, which runs the
kernels on a CUDA tensor and the plain version on a CPU one; a tanh
nn.RNN, and an LSTM in any other dtype (bf16 compute), the library's
recurrence (cuDNN on the card).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch import nn

from . import _kernels

_P = ctypes.c_void_p
_I = ctypes.c_int


def route(rnn: nn.RNNBase, xs: torch.Tensor) -> str:
    """'bilstm' (BiLSTM) or 'library' (torch.rnn_tanh / torch.lstm) for a
    BiRNN on xs."""
    dtypes = ((torch.float32,) if xs.is_cuda
              else (torch.float32, torch.float64))
    return ("bilstm" if isinstance(rnn, nn.LSTM) and xs.dtype in dtypes
            else "library")


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("lstm_recurrence")
    if not getattr(lib, "_typed", False):
        lib.asr_lstm_forward.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.asr_lstm_backward.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.asr_lstm_partial_floats.restype = ctypes.c_longlong
        lib.asr_lstm_partial_floats.argtypes = [_I, _I]
        lib.asr_lstm_ctas.argtypes = [_I]
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape: Sequence[int],
           device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"the LSTM kernels take float32; {name} is "
                         f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernels "
                         f"take {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_sizes(gates: torch.Tensor, w_hh: Sequence[torch.Tensor]
                 ) -> tuple:
    if not gates.is_cuda:
        raise ValueError(f"the LSTM kernels run on a CUDA tensor, not "
                         f"{gates.device}")
    if gates.dim() != 3 or len(w_hh) != 2:
        raise ValueError("gates must be (B, T, 8U) and w_hh a pair")
    B, T, U = gates.shape[0], gates.shape[1], gates.shape[2] // 8
    if U % 4 or U == 0:
        raise ValueError(f"the LSTM kernels take a multiple of 4 hidden "
                         f"units, got {gates.shape[2] / 8}")
    sms = torch.cuda.get_device_properties(gates.device).multi_processor_count
    ctas = _lib().asr_lstm_ctas(U)
    if ctas > sms:
        raise ValueError(f"{U} hidden units need {ctas} co-resident CTAs; "
                         f"the card has {sms} SMs")
    _check("gates", gates, (B, T, 8 * U), gates.device)
    for d, w in enumerate(w_hh):
        _check(f"w_hh[{d}]", w, (4 * U, U), gates.device)
    return B, T, U


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def recurrence_forward(gates: torch.Tensor, cells: torch.Tensor,
                       out: torch.Tensor, w_hh: Sequence[torch.Tensor]
                       ) -> None:
    """The kernels' forward recurrence, both directions, in place: gates
    (B, T, 8U) holds x W_ih^T + b and is overwritten with the activated
    gates; cells, out (B, T, 2U) receive c_t and h_t."""
    B, T, U = _check_sizes(gates, w_hh)
    for name, t in (("cells", cells), ("out", out)):
        _check(name, t, (B, T, 2 * U), gates.device)
    lib = _lib()
    counter = torch.zeros(2, dtype=torch.int32, device=gates.device)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    for d in range(2):
        _raise_on(lib.asr_lstm_forward(
            w_hh[d].data_ptr(), gates.data_ptr(), cells.data_ptr(),
            out.data_ptr(), counter[d].data_ptr(), B, T, U, d, stream),
            "lstm_forward_kernel")


def recurrence_backward(dgates: torch.Tensor, dout: torch.Tensor,
                        gates: torch.Tensor, cells: torch.Tensor,
                        w_hh: Sequence[torch.Tensor]) -> None:
    """The kernels' backward recurrence, both directions: dgates (B, T,
    8U) receives the gradient of the gates' pre-activations from dout
    (B, T, 2U) and the forward's activated gates and cells."""
    B, T, U = _check_sizes(gates, w_hh)
    _check("dgates", dgates, (B, T, 8 * U), gates.device)
    for name, t in (("dout", dout), ("cells", cells)):
        _check(name, t, (B, T, 2 * U), gates.device)
    lib = _lib()
    part = torch.empty(lib.asr_lstm_partial_floats(B, U),
                       dtype=torch.float32, device=gates.device)
    dcell = torch.empty(B, U, dtype=torch.float32, device=gates.device)
    counter = torch.zeros(2, dtype=torch.int32, device=gates.device)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    for d in range(2):
        _raise_on(lib.asr_lstm_backward(
            w_hh[d].data_ptr(), gates.data_ptr(), cells.data_ptr(),
            dout.data_ptr(), dgates.data_ptr(), part.data_ptr(),
            dcell.data_ptr(), counter[d].data_ptr(), B, T, U, d, stream),
            "lstm_backward_kernel")


def _order(d: int, T: int) -> range:
    return range(T) if d == 0 else range(T - 1, -1, -1)


def plain_forward(gates: torch.Tensor, cells: torch.Tensor,
                  out: torch.Tensor, w_hh: Sequence[torch.Tensor]) -> None:
    """recurrence_forward's arithmetic in PyTorch, one step at a time."""
    B, T, U = out.shape[0], out.shape[1], out.shape[2] // 2
    for d, w in enumerate(w_hh):
        g4, hu = slice(4 * U * d, 4 * U * (d + 1)), slice(U * d, U * (d + 1))
        h = c = None
        for t in _order(d, T):
            pre = gates[:, t, g4]
            if h is None:
                c = torch.zeros_like(pre[:, :U])
            else:
                pre = pre + h @ w.t()
            i, f, g, o = pre.chunk(4, -1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            c = f * c + i * g
            h = o * torch.tanh(c)
            gates[:, t, g4] = torch.cat([i, f, g, o], -1)
            cells[:, t, hu] = c
            out[:, t, hu] = h


def plain_backward(dgates: torch.Tensor, dout: torch.Tensor,
                   gates: torch.Tensor, cells: torch.Tensor,
                   w_hh: Sequence[torch.Tensor]) -> None:
    """recurrence_backward's arithmetic in PyTorch, one step at a time."""
    B, T, U = dout.shape[0], dout.shape[1], dout.shape[2] // 2
    for d, w in enumerate(w_hh):
        g4, hu = slice(4 * U * d, 4 * U * (d + 1)), slice(U * d, U * (d + 1))
        first = _order(d, T)[0]
        rec = dc = None
        for t in reversed(_order(d, T)):
            i, f, g, o = gates[:, t, g4].chunk(4, -1)
            c = cells[:, t, hu]
            c_prev = (cells[:, t - 1 if d == 0 else t + 1, hu]
                      if t != first else torch.zeros_like(c))
            dh = dout[:, t, hu] if rec is None else dout[:, t, hu] + rec
            tc = torch.tanh(c)
            dct = dh * o * (1 - tc * tc)
            if dc is not None:
                dct = dc + dct
            delta = torch.cat([dct * g * i * (1 - i),
                               dct * c_prev * f * (1 - f),
                               dct * i * (1 - g * g),
                               dh * tc * o * (1 - o)], -1)
            dgates[:, t, g4] = delta
            dc = dct * f
            rec = delta @ w


class BiLSTM(torch.autograd.Function):
    """(x (B, T, D), then for each direction w_ih (4U, D), w_hh (4U, U),
    bias (4U,)) -> (B, T, 2U) = [forward | reverse] outputs."""

    @staticmethod
    def forward(ctx, x, w_ih_f, w_hh_f, b_f, w_ih_b, w_hh_b, b_b):
        B, T, D = x.shape
        U = w_hh_f.shape[1]
        w_ih = torch.cat([w_ih_f, w_ih_b])
        x2 = x.reshape(B * T, D)
        gates = torch.addmm(torch.cat([b_f, b_b]), x2,
                            w_ih.t()).view(B, T, 8 * U)
        cells, out = x.new_empty(B, T, 2 * U), x.new_empty(B, T, 2 * U)
        core = recurrence_forward if x.is_cuda else plain_forward
        core(gates, cells, out, (w_hh_f, w_hh_b))
        ctx.save_for_backward(x2, w_ih, w_hh_f, w_hh_b, gates, cells, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, w_ih, w_hh_f, w_hh_b, gates, cells, out = ctx.saved_tensors
        B, T, G8 = gates.shape
        U = G8 // 8
        dgates = torch.empty_like(gates)
        core = recurrence_backward if dout.is_cuda else plain_backward
        core(dgates, dout.contiguous(), gates, cells, (w_hh_f, w_hh_b))
        # each step's h_prev: the output a step earlier in the direction's
        # order, zero at its first step
        hprev = torch.zeros_like(out)
        hprev[:, 1:, :U] = out[:, :-1, :U]
        hprev[:, :-1, U:] = out[:, 1:, U:]
        dg2, h2 = dgates.view(B * T, G8), hprev.view(B * T, 2 * U)
        need = ctx.needs_input_grad
        dx = (dg2 @ w_ih).view(B, T, -1) if need[0] else None
        dw_ih = dg2.t() @ x2
        db = dg2.sum(0)
        dw_hh = [dg2[:, 4 * U * d:4 * U * (d + 1)].t()
                 @ h2[:, U * d:U * (d + 1)] for d in range(2)]
        return (dx, dw_ih[:4 * U], dw_hh[0], db[:4 * U], dw_ih[4 * U:],
                dw_hh[1], db[4 * U:])


def bilstm(xs: torch.Tensor, weights: Sequence[torch.Tensor]
           ) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2U) through BiLSTM, from nn.LSTM's flat weight
    list (weight_ih, weight_hh, bias_ih, bias_hh, then the reverse
    direction's); bias_hh, the zero buffer make_birnn leaves, is added to
    bias_ih as nn.LSTM adds it, and takes no gradient."""
    w_ih_f, w_hh_f, b_ih_f, b_hh_f, w_ih_b, w_hh_b, b_ih_b, b_hh_b = weights
    return BiLSTM.apply(xs, w_ih_f, w_hh_f, b_ih_f + b_hh_f, w_ih_b, w_hh_b,
                        b_ih_b + b_hh_b)
