"""Layer functions in plain PyTorch (counterpart of
automatic_speech_recognition_tpu/ops/layers.py).

Weights are in PyTorch's layouts (Linear (out, in), Conv2d OIHW, nn.RNN);
JAX's dense_apply is nn.Linear.  Activations keep the JAX package's
layouts, so conv2d_apply takes and returns NHWC.  The semantics kept on
purpose:

- the reference's LAS "lstm" cells are vanilla tanh RNN cells,
  h' = tanh([x, h] @ W + b) with one bias; the language model's lstm and
  gru cells are TF's BasicLSTMCell and GRUCell over fused [x, h] weights
  (not nn.LSTM / nn.GRU, whose gate order and biases differ);
- the port's LSTM LAS (Config.rnn_cell 'lstm'): the BiRNNs are nn.LSTM
  (gates i, f, g, o; one bias, bias_hh a zero buffer) and the speller's
  cells are lstm_cell_apply's fused [x, h] cells, both c' = sig(f) c +
  sig(i) tanh(g), h' = sig(o) tanh(c'), forget bias 0;
- the bidirectional RNN's backward direction runs over the full padded
  sequence reversed (no sequence lengths), as nn.RNN does unpacked;
- conv2d: 3x3, stride 2, TF 'SAME' padding, which pads (0, 1) on an even
  length and (1, 1) on an odd one;
- batch norm over the last axis: (x - mean) * rsqrt(var + 1e-3) * scale +
  bias, from the stored moving statistics at inference; in training from
  the batch's (all axes but the last, padded positions included, biased
  variance, float32), with the moving update 0.99 old + 0.01 batch; under
  data parallelism the batch is the global one, as jnp.var over a
  'data'-sharded array gives it;
- dropout is inverted dropout; the embedding's variational noise is
  0.075 N(0, 1) over the whole table per lookup;
- under bf16 compute (models/las.compute_cast) batch norm keeps JAX's
  bn_apply dtype flow: statistics in float32, cast to the activation's
  dtype where they meet it;
- a cell or dense layer may be an int8 ops/quant.QuantLinear (inference
  only), called like the nn.Linear it replaces;
- under tensor parallelism (parallel/tensor_parallel.py) a split Linear
  gathers its own columns; `conv2d_layer` and `embed` compute their
  split conv's channels and table's columns and gather them, and
  `birnn_apply` runs cuDNN's RNN on the gathered whole weights (cuDNN
  takes whole matrices; a split recurrence would need a kernel of its
  own).

Randomness comes from an explicit torch.Generator on the tensor's device:
a stochastic function given none is a no-op, as a JAX function given no
key is.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed
from ..parallel import tensor_parallel as tp
from .quant import Dense


def glorot_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return weight.uniform_(-limit, limit, generator=generator)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     vn_std: float = 0.075) -> torch.Tensor:
    """Row lookup; with a generator, variational noise vn_std * N(0, 1) is
    added to the whole table first."""
    if generator is not None:
        table = table + vn_std * torch.randn(
            table.shape, generator=generator, device=table.device,
            dtype=table.dtype)
    return F.embedding(ids, table)


def embed(embedding: nn.Embedding, ids: torch.Tensor,
          generator: Optional[torch.Generator] = None,
          vn_std: float = 0.075) -> torch.Tensor:
    """embedding_lookup on an nn.Embedding.  A table split over a model
    axis (along E) looks up each position's columns and gathers them; the
    noise is drawn at the whole table's shape and sliced, so the draws do
    not depend on the split."""
    if not tp.is_split(embedding, "weight"):
        return embedding_lookup(embedding.weight, ids, generator, vn_std)
    tables = tp.parts(embedding, "weight")
    axis = embedding.tp_axis
    if generator is not None:
        noise = vn_std * torch.randn(
            (embedding.num_embeddings, embedding.embedding_dim),
            generator=generator, device=tables[0].device,
            dtype=tables[0].dtype)
        tables = [t + n for t, n in zip(tables, axis.split(noise, 1))]
    return axis.gather([F.embedding(i, t) for i, t in
                        zip(axis.scatter(ids), tables)], -1)


def rnn_cell_apply(cell: Dense, x: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Vanilla tanh RNN cell, one fused Linear over [x, h]."""
    return torch.tanh(cell(torch.cat([x, h], -1)))


def lstm_cell_apply(cell: Dense, x: torch.Tensor,
                    state: Tuple[torch.Tensor, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """TF BasicLSTMCell with forget_bias 0, as the reference's language
    model builds it: one fused Linear over [x, h] to 4U, gates in the
    order i, j, f, o.  Returns (h', (c', h'))."""
    c, h = state
    i, j, f, o = cell(torch.cat([x, h], -1)).chunk(4, -1)
    new_c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, (new_c, new_h)


class GRUCell(nn.Module):
    """TF GRUCell weights: `gates` over [x, h] to the r, u gates (bias
    initialized to 1.0), `candidate` over [x, r * h]."""

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.gates = nn.Linear(in_dim + units, 2 * units)
        self.candidate = nn.Linear(in_dim + units, units)


def gru_cell_apply(cell: GRUCell, x: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """TF GRUCell: u * h + (1 - u) * tanh([x, r * h] W_c + b_c)."""
    r, u = torch.sigmoid(cell.gates(torch.cat([x, h], -1))).chunk(2, -1)
    c = torch.tanh(cell.candidate(torch.cat([x, r * h], -1)))
    return u * h + (1.0 - u) * c


RNN_CELLS = ("rnn", "lstm")


def make_birnn(in_dim: int, units: int, cell: str = "rnn") -> nn.RNNBase:
    """Bidirectional tanh RNN ('rnn') or LSTM ('lstm').  The JAX cell's
    single bias is bias_ih; the second bias, bias_hh, is turned into a
    zero buffer: as a parameter it would take the same gradient as
    bias_ih and the optimizer would move the effective bias twice per
    step."""
    if cell == "rnn":
        rnn = nn.RNN(in_dim, units, nonlinearity="tanh", batch_first=True,
                     bidirectional=True)
    elif cell == "lstm":
        rnn = nn.LSTM(in_dim, units, batch_first=True, bidirectional=True)
    else:
        raise ValueError(f"--rnn_cell must be one of {RNN_CELLS}, got "
                         f"{cell!r}")
    gates = rnn.weight_hh_l0.shape[0]
    for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
        delattr(rnn, name)
        rnn.register_buffer(name, torch.zeros(gates))
    rnn._init_flat_weights()         # re-read the weight list the RNN runs
    return rnn


def birnn_apply(rnn: nn.RNNBase, xs: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2U) = [forward | backward] outputs, from zero
    states.  Weights split over a model axis are gathered whole first;
    cuDNN then copies them into its own buffer at every call, as they are
    not one flat chunk."""
    if tp.axis_of(rnn) is None:
        out, _ = rnn(xs)
        return out
    weights = [tp.full(rnn, name) for name in rnn._flat_weights_names]
    h0 = xs.new_zeros(2, xs.shape[0], rnn.hidden_size)
    if isinstance(rnn, nn.LSTM):
        out, _, _ = torch.lstm(xs, (h0, torch.zeros_like(h0)), weights,
                               True, 1, 0.0, rnn.training, True, True)
    else:
        out, _ = torch.rnn_tanh(xs, h0, weights, True, 1, 0.0,
                                rnn.training, True, True)
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


def conv2d_layer(conv: nn.Conv2d, x: torch.Tensor, stride: int = 2
                 ) -> torch.Tensor:
    """conv2d_apply with a Conv2d's weights; split over a model axis, each
    position's output channels, gathered, plus the whole bias."""
    if not tp.is_split(conv, "weight"):
        return conv2d_apply(x, conv.weight, conv.bias, stride)
    return tp.column(conv, lambda xi, w: conv2d_apply(xi, w, None, stride),
                     x) + conv.bias


def bn_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor,
             eps: float = 1e-3) -> torch.Tensor:
    """Inference batch norm over the last axis; the float32 statistics
    are cast to x's dtype."""
    return ((x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
            * scale + bias)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor, momentum: float = 0.99,
             eps: float = 1e-3, group: distributed.Group = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training batch norm: normalize with the batch statistics over every
    axis but the last (no length mask), and return the new moving
    statistics, which carry no gradient.  With a process group the
    statistics are those of the global batch, in two passes that carry
    the gradient through the group's sums: the mean from the summed sums
    and counts, then the variance from the summed squared deviations from
    it (not E[x^2] - E[x]^2, which cancels)."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    if group is None:
        b_var, b_mean = torch.var_mean(xf, axes, correction=0)
    else:
        count = distributed.reduced(
            torch.tensor(float(xf[..., 0].numel()), device=x.device), group)
        b_mean = distributed.all_reduce_sum(xf.sum(axes), group) / count
        b_var = distributed.all_reduce_sum(
            ((xf - b_mean) ** 2).sum(axes), group) / count
    with torch.no_grad():
        new = (momentum * mean + (1 - momentum) * b_mean,
               momentum * var + (1 - momentum) * b_var)
    y = ((x - b_mean.to(x.dtype)) * torch.rsqrt(b_var + eps).to(x.dtype)
         * scale + bias)
    return y, new


def dropout(x: torch.Tensor, rate: float, is_training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate).  A no-op at inference, at rate 0 or
    without a generator."""
    if not is_training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def length_mask(lengths: torch.Tensor, padded_len: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) -> (B, T) 1/0 mask: position p (1-based) is kept if p <= len."""
    pos = torch.arange(1, padded_len + 1, device=lengths.device)[None, :]
    return (pos <= lengths[:, None].to(torch.int64)).to(dtype)


class BatchNorm(nn.Module):
    """tf.layers.batch_normalization state: scale/bias parameters and
    mean/var moving statistics.  `forward` is inference; `normalize`
    takes the branch from an explicit is_training (not from
    self.training: the model stays in train mode for cuDNN's RNN
    backward) and returns the new statistics instead of writing them."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_apply(x, self.scale, self.bias, self.mean, self.var)

    def normalize(self, x: torch.Tensor, is_training: bool,
                  group: distributed.Group = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(y, (new mean, new var)); at inference the state is unchanged.
        In training, `group` makes the statistics the global batch's."""
        if is_training:
            return bn_train(x, self.scale, self.bias, self.mean, self.var,
                            group=group)
        return self(x), (self.mean, self.var)
