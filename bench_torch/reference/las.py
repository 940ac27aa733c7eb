"""Plain PyTorch reference of the LAS recognizer the benchmark measures,
and the reference module (see reference/__init__.py) that every LAS
configuration names: its parameters, its forward operations and its
check.

Written from the published description of the recipe and of its port,
with no import of the program: weights come in as a dict of tensors keyed
by the program's state-dict names (made by bench_torch/weights.py from the
seed), and every function here is a straight loop of torch operations in
float32.  `precision(tf32)` switches matmuls and cuDNN convolutions to
TF32: that is the control, the step below float32 that would tempt a
change to the program.

Semantics followed (and where they depart from Chan et al. 2016):
- frontend: 25 ms frames every 10 ms, 512-point power spectrum / 512,
  speechpy's mel filterbank (its lower edge 0 reads as 300 Hz), mfcc =
  DCT-II (ortho) of the log mel energies with c0 = log frame energy, or
  fbank = the mel energies; per-utterance CMVN over the valid frames
  (population std + 2^-30), deltas along the FEATURE axis (speechpy),
  frames past the valid count zeroed;
- listener 'cnn': two 3x3 stride-2 TF-SAME convs + ReLU, then BiRNN ->
  projection -> batch norm -> ReLU per layer; 'pblstm': BiRNN, tanh
  projection, then pyramid stages that concatenate frame pairs (the
  projection after each stage is the port's, not the paper's);
- the RNNs are tanh RNN cells with one bias (the recipe's "lstm" cells
  are vanilla RNN cells); the bidirectional RNN runs over the padded
  sequence, the backward direction from the padded end;
- speller: SOS embedding first, attention query = all layer states in
  layer order, additive ('add') or location-aware ('loc') attention with
  energies past the encoder length at -1e8;
- loss: label-smoothed (0.01) cross entropy over non-PAD positions;
  Adam (0.9, 0.999, 1e-8) after clipping by the global norm.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD, SOS, EOS = 0, 1, 2
EPS_CMVN = 2.0 ** -30
FLT_MIN = float(np.finfo(np.float32).tiny)
EPS64 = float(np.finfo(np.float64).eps)
NEG_ATT = -1e8

W = Dict[str, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """float32 (TF32 off) or, for the control, TF32 matmuls and convs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------ parameters

def enc_dim(c: dict) -> int:
    return c["enc_units"] if c["enc_type"] == "cnn" else 2 * c["enc_units"]


def param_spec(c: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every tensor of the model's state dict.
    init: ('glorot', fan_in, fan_out) uniform, ('uniform', limit),
    ('normal', std), ('const', value)."""
    out = []

    def linear(name, i, o, bias=True):
        out.append((f"{name}.weight", (o, i), ("glorot", i, o)))
        if bias:
            out.append((f"{name}.bias", (o,), ("const", 0.0)))

    def birnn(name, i, u):
        for sfx in ("l0", "l0_reverse"):
            out.append((f"{name}.weight_ih_{sfx}", (u, i), ("glorot", i + u, u)))
            out.append((f"{name}.weight_hh_{sfx}", (u, u), ("glorot", i + u, u)))
            out.append((f"{name}.bias_ih_{sfx}", (u,), ("const", 0.0)))
            out.append((f"{name}.bias_hh_{sfx}", (u,), ("const", 0.0)))

    def bn(name, d):
        out.extend([(f"{name}.scale", (d,), ("const", 1.0)),
                    (f"{name}.bias", (d,), ("const", 0.0)),
                    (f"{name}.mean", (d,), ("const", 0.0)),
                    (f"{name}.var", (d,), ("const", 1.0))])

    u = c["enc_units"]
    if c["enc_type"] == "cnn":
        ch = c["num_enc_channels"]
        out.append(("listener.conv0.weight", (ch, 3, 3, 3), ("normal", 0.01)))
        out.append(("listener.conv0.bias", (ch,), ("const", 0.01)))
        out.append(("listener.conv1.weight", (ch, ch, 3, 3), ("normal", 0.01)))
        out.append(("listener.conv1.bias", (ch,), ("const", 0.01)))
        if c.get("apply_bn"):
            bn("listener.bn_conv0", ch)
            bn("listener.bn_conv1", ch)
        d = _ceil_half(_ceil_half(c["feat_dim"])) * ch
        for i in range(c["num_enc_layers"]):
            birnn(f"listener.layers.{i}.birnn", d, u)
            linear(f"listener.layers.{i}.proj", 2 * u, u)
            if c.get("apply_bn"):
                bn(f"listener.layers.{i}.bn_extra", u)
            bn(f"listener.layers.{i}.bn_main", u)
            d = u
    else:
        birnn("listener.birnn0", 3 * c["feat_dim"], u)
        linear("listener.proj0", 2 * u, 2 * u)
        for i in range(c["num_enc_layers"]):
            birnn(f"listener.pyr.{i}.birnn", 2 * u, u)
            linear(f"listener.pyr.{i}.proj", 4 * u, 2 * u)
    h = enc_dim(c)
    V, E, U, A = (c["vocab_size"], c["embedding_size"], c["dec_units"],
                  c["attention_size"])
    out.append(("speller.embedding.weight", (V, E), ("uniform", 1.0)))
    linear("speller.attention.w_h", h, A, bias=False)
    linear("speller.attention.w_s", U * c["num_dec_layers"], A, bias=False)
    out.append(("speller.attention.u", (A,), ("uniform", 1.0)))
    if c["mode"] == "loc":
        K, C = c["loc_kernel_size"], c["loc_num_channels"]
        linear("speller.attention.w_f", C, A, bias=False)
        out.append(("speller.attention.conv_w", (C, 1, K),
                    ("uniform", math.sqrt(6.0 / (K + K * C)))))
        out.append(("speller.attention.conv_b", (C,), ("const", 0.0)))
    linear("speller.out", U, V)
    d = E + h
    for i in range(c["num_dec_layers"]):
        linear(f"speller.cells.{i}", d + U, U)
        d = U
    if c.get("ctc"):
        linear("speller.ctc_head", h, V + 1)
    return out


def trainable(name: str) -> bool:
    """The tensors the optimizer moves: not the BiRNNs' zero bias_hh, not
    batch norm's moving statistics."""
    return not (".bias_hh_" in name or name.endswith(".mean")
                or name.endswith(".var"))


def _ceil_half(x):
    return (x + x % 2) // 2


# -------------------------------------------------------------------- work

def _birnn_flops(T: int, d_in: int, u: int) -> float:
    return 2 * T * (2 * d_in * u + 2 * u * u)


def listener_flops(c: dict, frames: int) -> float:
    """Forward operations of the listener over `frames` real frames."""
    u, D = c["enc_units"], c["feat_dim"]
    if c["enc_type"] == "cnn":
        C = c["num_enc_channels"]
        t1, d1 = _ceil_half(frames), _ceil_half(D)
        t2, d2 = _ceil_half(t1), _ceil_half(d1)
        ops = 2 * t1 * d1 * C * 27 + 2 * t2 * d2 * C * C * 9
        d = d2 * C
        for _ in range(c["num_enc_layers"]):
            ops += _birnn_flops(t2, d, u) + 2 * t2 * 2 * u * u
            d = u
        return ops
    T = frames
    ops = _birnn_flops(T, 3 * D, u) + 2 * T * 2 * u * 2 * u
    for _ in range(c["num_enc_layers"]):
        ops += _birnn_flops(T, 2 * u, u)
        T = _ceil_half(T)
        ops += 2 * T * 4 * u * 2 * u
    return ops


def enc_frames(c: dict, frames: int) -> int:
    t = frames
    for _ in range(2 if c["enc_type"] == "cnn" else c["num_enc_layers"]):
        t = _ceil_half(t)
    return t


def speller_step_flops(c: dict, t_enc: int) -> float:
    """One decoder step for one row attending over t_enc frames."""
    h = enc_dim(c)
    A, U, L, E, V = (c["attention_size"], c["dec_units"],
                     c["num_dec_layers"], c["embedding_size"],
                     c["vocab_size"])
    ops = 2 * L * U * A + 3 * t_enc * A + 3 * t_enc + 2 * t_enc * h
    if c["mode"] == "loc":
        C, K = c["loc_num_channels"], c["loc_kernel_size"]
        ops += 2 * t_enc * C * K + 2 * t_enc * C * A
    d = E + h
    for _ in range(L):
        ops += 2 * (d + U) * U
        d = U
    return ops + 2 * U * V


def model_flops(c: dict, frames: int, steps: int) -> float:
    """Listener, the attention's encoder projection and `steps`
    teacher-forced or greedy decoder steps of one utterance (the
    frontend is work.py's)."""
    t = enc_frames(c, frames)
    return (listener_flops(c, frames)
            + 2 * t * enc_dim(c) * c["attention_size"]
            + steps * speller_step_flops(c, t))


# --------------------------------------------------------------- frontend

def _mel_filterbank(num_filters: int, coefficients: int, sample_rate: int
                    ) -> np.ndarray:
    """speechpy.feature.filterbanks with low_freq 0 (read as 300 Hz, as
    speechpy's `low_freq or 300` does) and high_freq sample_rate / 2."""
    high, low = sample_rate / 2, 300
    to_mel = lambda f: 1127.0 * np.log(1 + np.asarray(f, np.float64) / 700.0)
    mels = np.linspace(to_mel(low), to_mel(high), num_filters + 2)
    hertz = 700.0 * (np.exp(mels / 1127.0) - 1)
    idx = np.floor((coefficients + 1) * hertz / sample_rate).astype(int)
    fb = np.zeros((num_filters, coefficients))
    x = np.arange(coefficients)
    for i in range(num_filters):
        left, mid, right = idx[i], idx[i + 1], idx[i + 2]
        tri = np.zeros(coefficients)
        up = (left < x) & (x <= mid)
        tri[up] = (x[up] - left) / (mid - left)
        down = (mid <= x) & (x < right)
        tri[down] = (right - x[down]) / (right - mid)
        tri[x <= left] = 0
        tri[x >= right] = 0
        fb[i] = tri
    return fb


def _dct(n_in: int, n_out: int) -> np.ndarray:
    """scipy dct(type=2, norm='ortho')[:, :n_out] as an (n_in, n_out)
    matrix."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    m = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    scale = np.full((n_out, 1), np.sqrt(2.0 / n_in))
    scale[0, 0] = np.sqrt(1.0 / n_in)
    return (m * scale).T


def frame_params(c: dict) -> Tuple[int, int]:
    sr = c["sample_rate"]
    return (int(round(sr * c["frame_length"] / 1000.0)),
            int(round(sr * c["frame_step"] / 1000.0)))


def num_frames(samples: int, c: dict) -> int:
    flen, step = frame_params(c)
    return 0 if samples < flen else (samples - flen) // step


def features(audio: torch.Tensor, lens: torch.Tensor, c: dict
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) waveforms -> ((B, T, D, 3) features, (B,) frame counts),
    T from S."""
    flen, step = frame_params(c)
    B, S = audio.shape
    T = max(num_frames(S, c), 1)
    dev = audio.device
    featlen = torch.clamp(torch.div(lens.to(dev).long() - flen, step,
                                    rounding_mode="floor"), 0, T)
    idx = (torch.arange(T, device=dev)[:, None] * step
           + torch.arange(flen, device=dev)).clamp(max=S - 1)
    frames = audio.float()[:, idx]                              # (B, T, flen)
    n_fft = c["fft_length"]
    ps = torch.fft.rfft(frames, n=n_fft).abs().square() / n_fft
    K = n_fft // 2 + 1
    zero = lambda x: torch.where(x < FLT_MIN, torch.full_like(x, EPS64), x)
    D = c["feat_dim"]
    if c["feat_type"] == "mfcc":
        fb = torch.tensor(_mel_filterbank(c["num_mel_filters"], K,
                                          c["sample_rate"]).T,
                          dtype=torch.float32, device=dev)
        dct = torch.tensor(_dct(c["num_mel_filters"], D),
                           dtype=torch.float32, device=dev)
        feat = torch.log(zero(ps @ fb)) @ dct
        feat[..., 0] = torch.log(zero(ps.sum(-1)))
    else:
        fb = torch.tensor(_mel_filterbank(D, K, c["sample_rate"]).T,
                          dtype=torch.float32, device=dev)
        feat = zero(ps @ fb)
    valid = (torch.arange(T, device=dev)[None, :]
             < featlen[:, None]).float()[..., None]             # (B, T, 1)
    count = featlen.clamp(min=1).float()[:, None, None]
    mean = (feat * valid).sum(1, keepdim=True) / count
    centered = (feat - mean) * valid
    std = ((centered * centered).sum(1, keepdim=True) / count).sqrt()
    feat = centered / (std + EPS_CMVN)

    def delta(x):
        i = torch.arange(-2, D + 2, device=dev).clamp(0, D - 1)
        p = x[..., i]
        return (p[..., 3:3 + D] - p[..., 1:1 + D]
                + 2.0 * p[..., 4:4 + D] - p[..., 0:D]) / 10.0

    d1 = delta(feat)
    out = torch.stack([feat, d1, delta(d1)], -1) * valid[..., None]
    return out, featlen.int()


# ---------------------------------------------------------------- listener

def _birnn(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2U): tanh RNN forward and backward over the
    whole padded sequence from zero states."""
    outs = []
    for sfx, order in (("l0", range(x.shape[1])),
                       ("l0_reverse", range(x.shape[1] - 1, -1, -1))):
        xw = x @ w[f"{name}.weight_ih_{sfx}"].T + w[f"{name}.bias_ih_{sfx}"]
        whh = w[f"{name}.weight_hh_{sfx}"].T
        h = x.new_zeros(x.shape[0], whh.shape[0])
        hs = [None] * x.shape[1]
        for t in order:
            h = torch.tanh(xw[:, t] + h @ whh)
            hs[t] = h
        outs.append(torch.stack(hs, 1))
    return torch.cat(outs, -1)


def _linear(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ w[f"{name}.weight"].T
    b = w.get(f"{name}.bias")
    return y if b is None else y + b


def _same_pad(n: int) -> Tuple[int, int]:
    out = -(-n // 2)
    total = max((out - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def _batch_norm(w: W, name: str, x: torch.Tensor, training: bool
                ) -> torch.Tensor:
    if training:
        axes = tuple(range(x.dim() - 1))
        var, mean = torch.var_mean(x, axes, correction=0)
    else:
        mean, var = w[f"{name}.mean"], w[f"{name}.var"]
    return ((x - mean) * torch.rsqrt(var + 1e-3) * w[f"{name}.scale"]
            + w[f"{name}.bias"])


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
            x = _linear(w, f"{p}.proj", _birnn(w, f"{p}.birnn", x))
            if c.get("apply_bn"):
                x = _batch_norm(w, f"{p}.bn_extra", x, training)
            x = torch.relu(_batch_norm(w, f"{p}.bn_main", x, training))
        return x, lens
    B, T, D, C = feats.shape
    x = feats.reshape(B, T, D * C)
    x = torch.tanh(_linear(w, "listener.proj0",
                           _birnn(w, "listener.birnn0", x)))
    for i in range(c["num_enc_layers"]):
        x = _birnn(w, f"listener.pyr.{i}.birnn", x)
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
    states = [enc.new_zeros(B, U) for _ in range(L)]
    align = enc.new_zeros(B, T)
    emb = table[torch.full((B,), SOS, dtype=torch.long, device=enc.device)]
    loc = c["mode"] == "loc"
    if loc:
        K = c["loc_kernel_size"]
        low = (K - 1) // 2
    out = []
    for t in range(fed.shape[1]):
        s = torch.cat(states, -1)
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
            x = torch.tanh(_linear(w, f"speller.cells.{l}",
                                   torch.cat([x, states[l]], -1)))
            states[l] = x
        out.append(_linear(w, "speller.out", x))
        emb = table[fed[:, t].long()]
    return torch.stack(out, 1)


def forced_logits(w: W, c: dict, audio: torch.Tensor, lens: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Inference logits of the served tokens: (B, steps, V)."""
    feats, featlen = features(audio, lens, c)
    enc, enc_len = listen(w, c, feats, featlen)
    return spell(w, c, enc, enc_len, tokens)


# ---------------------------------------------------------------- training

def loss(w: W, c: dict, audio: torch.Tensor, lens: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """The training loss of one batch of raw audio and padded labels: the
    decoder runs y's whole width, PAD positions masked.  The joint CTC
    loss is not followed here: a configuration that trains with it is
    refused."""
    if c.get("ctc"):
        raise ValueError("the reference does not follow CTC training")
    feats, featlen = features(audio, lens, c)
    featlen = featlen.clamp(min=1)
    enc, enc_len = listen(w, c, feats, featlen, training=True)
    logits = spell(w, c, enc, enc_len, y)
    V = c["vocab_size"]
    target = F.one_hot(y.long(), V).float()
    if c["label_smoothing"]:
        target = 0.99 * target + 0.01 / V
    ce = -(target * torch.log_softmax(logits, -1)).sum(-1)
    m = (y != PAD).float()
    total = (ce * m).sum() / (m.sum() + 1e-9)
    return total


class Adam:
    """clip by global norm, then Adam (0.9, 0.999, 1e-8) at a fixed lr."""

    def __init__(self, params: W, lr: float, clip: float):
        self.p = params
        self.lr, self.clip = lr, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: W) -> None:
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        factor = 1.0 if float(norm) < self.clip else self.clip / norm
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            g = g * factor
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + 1e-8
            self.p[k].sub_(self.lr / bc1 * self.m[k] / denom)


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
            opt.step(g)
            if first is None:
                raw = {k: float(v.norm()) for k, v in g.items()}
                first = {k: float(opt.m[k].norm() / 0.1) for k in leaves}
    change = {k: float((leaves[k].detach() - w[k]).norm()) for k in leaves}
    return {"loss": losses, "first_grad": first, "raw_grad": raw,
            "change": change}

