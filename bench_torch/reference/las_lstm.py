"""Plain PyTorch reference of the LSTM LAS (LAS-d-w, Park et al. 2019,
"SpecAugment", arXiv:1904.08779 §3.1), the reference module (see
reference/__init__.py) of a configuration whose recurrent layers are LSTM
cells: its parameters, its forward operations, its check, and the work of
the listener's recurrences that the roofline reader divides by.

Written from the published description, with no import of the program:
weights come in as a dict of tensors keyed by the program's state-dict
names (bench_torch/weights.py draws them from the seed), and every
function is a straight loop of torch operations in float32, the LSTMs
written out one time step at a time.  What is the same mathematics as the
tanh-cell LAS is imported from las.py: the frontend, the frame
arithmetic, the convolutions' padding, batch norm, dense layers, the
parameter layout of everything but the cells, Adam after clipping, the
precision switch (TF32 is the control).

Semantics followed:
- an LSTM cell: c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c'),
  one bias (forget bias 0), zero initial states; the listener's cells in
  nn.LSTM's layout (weight_ih (4U, D), weight_hh (4U, U), gates i, f, g,
  o; bias_hh a zero buffer, not trained), the speller's as one fused
  [x, h] -> 4U layer, gates i, g, f, o (TensorFlow's BasicLSTMCell
  order); glorot-uniform over the fused [x, h] kernel, fan_in in + U and
  fan_out 4U;
- the bidirectional LSTM runs over the whole padded sequence, the
  backward direction from the padded end;
- listener 'cnn': two 3x3 stride-2 convs + ReLU (time / 4), then BiLSTM ->
  projection 2U -> U -> batch norm -> ReLU per layer ('pblstm': the
  tanh-cell LAS's pyramid with BiLSTMs);
- speller: SOS first, attention query = every layer's h in layer order,
  additive or location-aware attention, energies past the encoder length
  at -1e8;
- loss: label-smoothed (0.01) cross entropy over non-PAD positions.

Departures from Park et al.: no max-pooling (the stride-2 convs give the
paper's time / 4); no SpecAugment (the program draws its masks, which a
reference could not follow); label smoothing 0.01 where the paper's is
0.1, no beam search or language model; a projection, batch norm and ReLU
after each BiLSTM (the port's listener), and attention, embedding and
projection widths the paper does not give.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from bench_torch.reference import las
from bench_torch.reference.las import (
    NEG_ATT, PAD, SOS, W, Adam, _batch_norm, _ceil_half, _linear, _same_pad,
    enc_dim, enc_frames, features, precision, trainable)

GATES = 4

# ------------------------------------------------------------ parameters


def param_spec(c: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every tensor of the model's state dict: the
    tanh-cell LAS's (las.param_spec), each recurrent tensor's rows widened
    to the 4 gates and its glorot fan_out with them."""
    out = []
    for name, shape, init in las.param_spec(c):
        recurrent = (".birnn" in name and "_l0" in name) or (
            name.startswith("speller.cells."))
        if recurrent:
            shape = (GATES * shape[0],) + tuple(shape[1:])
            if init[0] == "glorot":
                init = ("glorot", init[1], GATES * init[2])
        out.append((name, shape, init))
    return out


# -------------------------------------------------------------------- work

def _bilstm_flops(T: int, d_in: int, u: int) -> float:
    """Both directions over T frames: 2 * 4U (in + U) a frame each."""
    return 2 * T * 2 * GATES * u * (d_in + u)


def _birnn_layers(c: dict, frames: int) -> List[Tuple[int, int]]:
    """(time steps, input width) of each of the listener's BiLSTMs over
    `frames` feature frames."""
    u, D = c["enc_units"], c["feat_dim"]
    if c["enc_type"] == "cnn":
        t = _ceil_half(_ceil_half(frames))
        d = _ceil_half(_ceil_half(D)) * c["num_enc_channels"]
        return [(t, d if i == 0 else u) for i in range(c["num_enc_layers"])]
    out, t = [(frames, 3 * D)], frames
    for _ in range(c["num_enc_layers"]):
        out.append((t, 2 * u))
        t = _ceil_half(t)
    return out


def listener_flops(c: dict, frames: int) -> float:
    """Forward operations of the listener over `frames` real frames."""
    u, D = c["enc_units"], c["feat_dim"]
    ops = sum(_bilstm_flops(t, d, u) for t, d in _birnn_layers(c, frames))
    if c["enc_type"] == "cnn":
        C = c["num_enc_channels"]
        t1, d1 = _ceil_half(frames), _ceil_half(D)
        t2, d2 = _ceil_half(t1), _ceil_half(d1)
        return (ops + 2 * t1 * d1 * C * 27 + 2 * t2 * d2 * C * C * 9
                + c["num_enc_layers"] * 2 * t2 * 2 * u * u)
    T = frames
    ops += 2 * T * 2 * u * 2 * u
    for _ in range(c["num_enc_layers"]):
        T = _ceil_half(T)
        ops += 2 * T * 4 * u * 2 * u
    return ops


def speller_step_flops(c: dict, t_enc: int) -> float:
    """One decoder step for one row attending over t_enc frames: the
    tanh-cell LAS's count (las.speller_step_flops), its cells' products
    widened to the 4 gates."""
    U, d = c["dec_units"], c["embedding_size"] + enc_dim(c)
    cells = 0
    for _ in range(c["num_dec_layers"]):
        cells += 2 * (d + U) * U
        d = U
    return las.speller_step_flops(c, t_enc) + (GATES - 1) * cells


def model_flops(c: dict, frames: int, steps: int) -> float:
    """Listener, the attention's encoder projection and `steps` decoder
    steps of one utterance (the frontend is work.py's)."""
    t = enc_frames(c, frames)
    return (listener_flops(c, frames)
            + 2 * t * enc_dim(c) * c["attention_size"]
            + steps * speller_step_flops(c, t))


def rnn_frames(c: dict, frames: int) -> int:
    """Frame-steps of the listener's BiLSTMs over `frames` feature
    frames: time steps x 2 directions, summed over its BiLSTMs (what the
    program's `las.listener.rnn_frames` counts a row, at the padded
    width)."""
    return sum(2 * t for t, _ in _birnn_layers(c, frames))


def rnn_work(c: dict, rows: int, frames: int) -> Tuple[float, float]:
    """(operations, bytes) of the listener's recurrences, forward and
    backward, in one training step of `rows` rows padded to `frames`
    feature frames.  Operations: the forward's 2 * 4U (in + U) a frame a
    direction, and the backward's twice that (the input's gradient and
    the weights').  Bytes, float32, each direction: the forward reads
    W_hh once a time step, W_ih, the input once, writes the output and
    the gates' reserve once; the backward reads W_hh once a time step,
    the reserve, the output's gradient and the input once, writes the
    input's gradient and the weights' gradients once."""
    u, B = c["enc_units"], rows
    ops = bytes_ = 0.0
    for t, d in _birnn_layers(c, frames):
        ops += 3 * B * _bilstm_flops(t, d, u)
        g = GATES * u
        fwd = t * g * u + g * d + B * t * d + B * t * u + B * t * g
        bwd = t * g * u + B * t * g + B * t * u + 2 * B * t * d + g * (d + u)
        bytes_ += 2 * 4 * (fwd + bwd)
    return ops, bytes_


# ---------------------------------------------------------------- listener

def _bilstm(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2U): LSTM forward and backward over the whole
    padded sequence from zero states (nn.LSTM's gates i, f, g, o)."""
    outs = []
    T = x.shape[1]
    for sfx, order in (("l0", range(T)), ("l0_reverse", range(T - 1, -1, -1))):
        xw = x @ w[f"{name}.weight_ih_{sfx}"].T + w[f"{name}.bias_ih_{sfx}"]
        whh = w[f"{name}.weight_hh_{sfx}"].T
        h = x.new_zeros(x.shape[0], whh.shape[0])
        cell = torch.zeros_like(h)
        hs = [None] * T
        for t in order:
            i, f, g, o = (xw[:, t] + h @ whh).chunk(GATES, -1)
            cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(cell)
            hs[t] = h
        outs.append(torch.stack(hs, 1))
    return torch.cat(outs, -1)


def listen(w: W, c: dict, feats: torch.Tensor, featlen: torch.Tensor,
           training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D, 3) -> (encoder output, encoder lengths)."""
    lens = featlen.long()
    if c["enc_type"] == "cnn":
        x = feats.permute(0, 3, 1, 2)                            # NCHW
        for i in range(2):
            th, tw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (tw[0], tw[1], th[0], th[1])),
                         w[f"listener.conv{i}.weight"],
                         w[f"listener.conv{i}.bias"], stride=2)
            if c.get("apply_bn"):
                x = _batch_norm(w, f"listener.bn_conv{i}",
                                x.permute(0, 2, 3, 1), training
                                ).permute(0, 3, 1, 2)
            x = torch.relu(x)
            lens = _ceil_half(lens)
        B, C, T, Dr = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T, Dr * C)
        for i in range(c["num_enc_layers"]):
            p = f"listener.layers.{i}"
            x = _linear(w, f"{p}.proj", _bilstm(w, f"{p}.birnn", x))
            if c.get("apply_bn"):
                x = _batch_norm(w, f"{p}.bn_extra", x, training)
            x = torch.relu(_batch_norm(w, f"{p}.bn_main", x, training))
        return x, lens
    B, T, D, C = feats.shape
    x = feats.reshape(B, T, D * C)
    x = torch.tanh(_linear(w, "listener.proj0",
                           _bilstm(w, "listener.birnn0", x)))
    for i in range(c["num_enc_layers"]):
        x = _bilstm(w, f"listener.pyr.{i}.birnn", x)
        if x.shape[1] % 2:
            x = F.pad(x, (0, 0, 0, 1))
        x = torch.tanh(_linear(w, f"listener.pyr.{i}.proj",
                               torch.cat([x[:, ::2], x[:, 1::2]], -1)))
        lens = _ceil_half(lens)
    return x, lens


# ------------------------------------------------------------------ speller

def spell(w: W, c: dict, enc: torch.Tensor, enc_len: torch.Tensor,
          fed: torch.Tensor) -> torch.Tensor:
    """Teacher-forced speller: logits (B, steps, V) for steps =
    fed.shape[1], SOS into the first step and fed[:, t] into step t + 1."""
    B, T, _ = enc.shape
    L, U = c["num_dec_layers"], c["dec_units"]
    table = w["speller.embedding.weight"]
    h_proj = enc @ w["speller.attention.w_h.weight"].T
    mask = torch.arange(T, device=enc.device)[None, :] < enc_len[:, None]
    hs = [enc.new_zeros(B, U) for _ in range(L)]
    cs = [enc.new_zeros(B, U) for _ in range(L)]
    align = enc.new_zeros(B, T)
    emb = table[torch.full((B,), SOS, dtype=torch.long, device=enc.device)]
    loc = c["mode"] == "loc"
    if loc:
        K = c["loc_kernel_size"]
        low = (K - 1) // 2
    out = []
    for t in range(fed.shape[1]):
        s = torch.cat(hs, -1)
        pre = h_proj + (s @ w["speller.attention.w_s.weight"].T)[:, None]
        if loc:
            f = F.conv1d(F.pad(align[:, None], (low, K - 1 - low)),
                         w["speller.attention.conv_w"],
                         w["speller.attention.conv_b"]).transpose(1, 2)
            pre = pre + f @ w["speller.attention.w_f.weight"].T
        energy = torch.tanh(pre) @ w["speller.attention.u"]
        energy = torch.where(mask, energy, torch.full_like(energy, NEG_ATT))
        align = torch.softmax(energy, -1)
        context = (align[:, :, None] * enc).sum(1)
        x = torch.cat([emb, context], -1)
        for l in range(L):
            i, g, f, o = _linear(w, f"speller.cells.{l}",
                                 torch.cat([x, hs[l]], -1)).chunk(GATES, -1)
            cs[l] = torch.sigmoid(f) * cs[l] + torch.sigmoid(i) * torch.tanh(g)
            hs[l] = x = torch.sigmoid(o) * torch.tanh(cs[l])
        out.append(_linear(w, "speller.out", x))
        emb = table[fed[:, t].long()]
    return torch.stack(out, 1)


def forced_logits(w: W, c: dict, audio: torch.Tensor, lens: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Inference logits of the given tokens: (B, steps, V)."""
    feats, featlen = features(audio, lens, c)
    enc, enc_len = listen(w, c, feats, featlen)
    return spell(w, c, enc, enc_len, tokens)


# ---------------------------------------------------------------- training

def loss(w: W, c: dict, audio: torch.Tensor, lens: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """The training loss of one batch of raw audio and padded labels: the
    decoder runs y's whole width, PAD positions masked (joint CTC is not
    followed: a configuration that trains with it is refused)."""
    if c.get("ctc"):
        raise ValueError("the reference does not follow CTC training")
    feats, featlen = features(audio, lens, c)
    enc, enc_len = listen(w, c, feats, featlen.clamp(min=1), training=True)
    return sequence_loss(spell(w, c, enc, enc_len, y), y, c)


def sequence_loss(logits: torch.Tensor, y: torch.Tensor, c: dict
                  ) -> torch.Tensor:
    """Label-smoothed cross entropy of (B, steps, V) logits against the
    padded labels, averaged over the non-PAD positions."""
    V = c["vocab_size"]
    target = F.one_hot(y.long(), V).float()
    if c["label_smoothing"]:
        target = 0.99 * target + 0.01 / V
    ce = -(target * torch.log_softmax(logits, -1)).sum(-1)
    m = (y != PAD).float()
    return (ce * m).sum() / (m.sum() + 1e-9)


def train_steps(w: W, c: dict, batches, tf32: bool = False) -> dict:
    """Follow the program's first len(batches) steps from weights w:
    the loss of each, the per-leaf norm of the first step's clipped
    gradient, the per-leaf raw gradient norm of the first step, and the
    per-leaf norm of the change after the last."""
    params = {k: v.detach().clone().requires_grad_(trainable(k))
              for k, v in w.items()}
    leaves = {k: v for k, v in params.items() if trainable(k)}
    opt = Adam(leaves, c["lr"], c["grad_clip"])
    losses, first, raw = [], None, None
    with precision(tf32):
        for audio, lens, y in batches:
            value = loss(params, c, audio, lens, y)
            grads = torch.autograd.grad(value, list(leaves.values()))
            g = dict(zip(leaves, grads))
            losses.append(float(value.detach()))
            del value, grads
            opt.step(g)
            if first is None:
                raw = {k: float(v.norm()) for k, v in g.items()}
                first = {k: float(opt.m[k].norm() / 0.1) for k in leaves}
            del g
    change = {k: float((leaves[k].detach() - w[k]).norm()) for k in leaves}
    return {"loss": losses, "first_grad": first, "raw_grad": raw,
            "change": change}
