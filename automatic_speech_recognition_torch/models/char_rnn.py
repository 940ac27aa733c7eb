"""Character RNN language model (counterpart of
automatic_speech_recognition_tpu/models/char_rnn.py), fused into beam
search (decoding/beam.py).

Embedding-or-one-hot input -> stacked {rnn | lstm | gru} cells -> dense
softmax head, with the reference's quirks kept:

- 'lstm' is TF BasicLSTMCell with forget_bias 0, 'gru' TF GRUCell, 'rnn'
  the tanh cell (ops/layers.py), each over fused [x, h] weights;
- embedding_size <= 0 means one-hot inputs, and then no input dropout;
- a negative id embeds to a zero vector in both modes: fusion feeds
  prev_ids - 2, so <SOS> = 1 arrives as -1 (nn.Embedding and F.one_hot
  would raise on it);
- dropout is output dropout on every cell (the recurrent state stays
  undropped) and input dropout on the embedded ids, training only, chosen
  by an explicit is_training and drawn from an explicit torch.Generator,
  as in models/las.py;
- for fusion under --quantize_decoder int8, ops/quant.quantize_lm turns
  the rnn / lstm cells into int8 QuantLinear modules, which the cell
  functions call as the Linear they replace; the LM is never cast to
  bf16 (the JAX package casts only the LAS parameters).

Training: `lm_train_step` is one optimization step over (B, T) ids with
the recurrent state carried across steps as a value (detached between
steps: truncated BPTT, as jax.value_and_grad gives), clip by global norm
(dividing by the norm itself, as optax does) then Adam; dropout draws from
the state's generator.  `BatchGenerator` (cursor batching, framework-free,
copied as it is) feeds it; `sample_seq` samples greedily or by
temperature from an explicit generator.

An LM directory has the layout train_lm.py writes and sample_lm.load_lm
reads: result.json ({"params": LMConfig fields, "best_model": epoch,
...}), vocab.json (char -> id) and lang/best_model/<epoch>.pt, the last in
the port's checkpoint format (training/checkpoint.py); the port's
train_lm writes it with the full train state there and in
lang/save_model/.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from automatic_speech_recognition_torch.utils.text import lm_vocab

from ..ops import layers as L
from ..training.checkpoint import CheckpointManager
from ..training.trainer import clip_by_global_norm

LSTMState = Tuple[torch.Tensor, torch.Tensor]
LMState = Tuple[Union[torch.Tensor, LSTMState], ...]


@dataclass(frozen=True)
class LMConfig:
    """Mirrors train_lm.py flag names/defaults (train_lm.py:42-73)."""
    vocab_size: int = 28
    hidden_size: int = 128
    embedding_size: int = 0          # <=0 -> one-hot input
    num_layers: int = 2
    num_unrollings: int = 10
    batch_size: int = 20
    model: str = "lstm"              # 'rnn' | 'lstm' | 'gru'
    learning_rate: float = 2e-3
    max_grad_norm: float = 5.0
    dropout: float = 0.0
    input_dropout: float = 0.0

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "LMConfig":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(LMConfig)}
        return LMConfig(**{k: v for k, v in d.items() if k in fields})

    @property
    def input_size(self) -> int:
        return (self.embedding_size if self.embedding_size > 0
                else self.vocab_size)

    @property
    def effective_input_dropout(self) -> float:
        """No dropout on one-hot representations
        (lang/char_rnn_model.py:30-34)."""
        return self.input_dropout if self.embedding_size > 0 else 0.0


class CharRNN(nn.Module):
    """Parameters of the LM: `embedding` (embedding mode only), `cells`
    (nn.Linear for rnn and lstm, layers.GRUCell for gru) and `softmax`."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        if cfg.model not in ("rnn", "lstm", "gru"):
            raise ValueError(f"unknown LM cell {cfg.model!r}")
        H = cfg.hidden_size
        self.embedding = (nn.Embedding(cfg.vocab_size, cfg.embedding_size)
                          if cfg.embedding_size > 0 else None)
        self.cells = nn.ModuleList()
        in_dim = cfg.input_size
        for _ in range(cfg.num_layers):
            if cfg.model == "gru":
                self.cells.append(L.GRUCell(in_dim, H))
            else:
                self.cells.append(nn.Linear(
                    in_dim + H, 4 * H if cfg.model == "lstm" else H))
            in_dim = H
        self.softmax = nn.Linear(H, cfg.vocab_size)


@torch.no_grad()
def init(cfg: LMConfig, generator: torch.Generator,
         device: torch.device) -> CharRNN:
    """A CharRNN with lm_init's distributions: glorot-uniform embedding,
    cell kernels and softmax, zero biases except the GRU gates' 1.0.
    `generator` is a CPU generator."""
    model = CharRNN(cfg)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            L.glorot_uniform_(m.weight, m.in_features, m.out_features,
                              generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            L.glorot_uniform_(m.weight, *m.weight.shape, generator)
    for cell in model.cells:
        if isinstance(cell, L.GRUCell):
            cell.gates.bias.fill_(1.0)   # TF GRUCell gate bias init
    return model.to(device).eval()


def zero_state(cfg: LMConfig, batch: int,
               device: Optional[torch.device] = None) -> LMState:
    """Per-layer zero state; lstm carries (c, h), rnn/gru carry h."""
    z = lambda: torch.zeros(batch, cfg.hidden_size, device=device)
    if cfg.model == "lstm":
        return tuple((z(), z()) for _ in range(cfg.num_layers))
    return tuple(z() for _ in range(cfg.num_layers))


def _embed(model: CharRNN, cfg: LMConfig, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup, or one-hot when embedding_size <= 0; a negative id
    gives a zero vector (clamp, look up, then zero)."""
    safe = ids.long().clamp(min=0)
    if cfg.embedding_size > 0:
        x = L.embed(model.embedding, safe)
    else:
        x = F.one_hot(safe, cfg.vocab_size).to(torch.float32)
    return x.masked_fill((ids < 0)[..., None], 0.0)


def lm_step(model: CharRNN, cfg: LMConfig, ids: torch.Tensor, state: LMState,
            is_training: bool = False,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, LMState]:
    """One LM step: ids (B,) -> (logits (B, V), new state).  Training with
    a generator: input dropout on the embedded ids and output dropout on
    every cell."""
    x = L.dropout(_embed(model, cfg, ids), cfg.effective_input_dropout,
                  is_training, generator)
    new_state = []
    for cell, s in zip(model.cells, state):
        if cfg.model == "lstm":
            x, s = L.lstm_cell_apply(cell, x, s)
        elif cfg.model == "gru":
            x = s = L.gru_cell_apply(cell, x, s)
        else:
            x = s = L.rnn_cell_apply(cell, x, s)
        new_state.append(s)
        x = L.dropout(x, cfg.dropout, is_training, generator)
    return model.softmax(x), tuple(new_state)


def lm_apply(model: CharRNN, cfg: LMConfig, inputs: torch.Tensor,
             state: LMState, is_training: bool = False,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, LMState]:
    """Unrolled forward: inputs (B, T) -> (logits (B, T, V), final state)."""
    logits = []
    for t in range(inputs.shape[1]):
        lg, state = lm_step(model, cfg, inputs[:, t], state, is_training,
                            generator)
        logits.append(lg)
    return torch.stack(logits, 1), state


def lm_loss(model: CharRNN, cfg: LMConfig, inputs: torch.Tensor,
            targets: torch.Tensor, state: LMState, is_training: bool = False,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, LMState]:
    """Mean sparse CE over all positions (lang/char_rnn_model.py:145-148).
    Returns (loss, final state)."""
    logits, state = lm_apply(model, cfg, inputs, state, is_training,
                             generator)
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean(), state


class LMOptimizer:
    """clip_by_global_norm(max_grad_norm) -> adam(learning_rate): the optax
    chain of make_lm_optimizer.  Adam's bias correction is float64 here,
    float32 in optax (about 3e-5 relative at t = 1)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], cfg: LMConfig):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_grad_norm = cfg.max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=cfg.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)

    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one step's gradients (aligned with params)."""
        for p, g in zip(self.params,
                        clip_by_global_norm(grads, self.max_grad_norm)):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        self.adam.load_state_dict(state)


def make_lm_optimizer(model: CharRNN, cfg: LMConfig) -> LMOptimizer:
    return LMOptimizer(model.parameters(), cfg)


@dataclass
class LMTrainState:
    """Model, optimizer, step count and the generator dropout draws from
    (on the model's device); training/checkpoint.py saves and restores
    it."""
    model: CharRNN
    optimizer: LMOptimizer
    step: int
    generator: torch.Generator


def create_lm_train_state(cfg: LMConfig, seed: int,
                          device: torch.device) -> LMTrainState:
    """Weights from `seed` (lm_init's distributions) and a generator on
    the device seeded with it."""
    model = init(cfg, torch.Generator().manual_seed(seed), device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return LMTrainState(model, make_lm_optimizer(model, cfg), 0, generator)


def _detach(state: LMState) -> LMState:
    return tuple(tuple(x.detach() for x in s) if isinstance(s, tuple)
                 else s.detach() for s in state)


def lm_train_step(ts: LMTrainState, inputs: torch.Tensor,
                  targets: torch.Tensor, state: LMState, cfg: LMConfig
                  ) -> Tuple[torch.Tensor, LMState]:
    """One optimization step on (B, T) ids, in place on ts, carrying the
    recurrent state across steps like the reference's stateful epoch loop
    (lang/char_rnn_model.py:216-232).  Returns (loss, final state), both
    detached: the next step's backward stops at its own first input."""
    loss, final_state = lm_loss(ts.model, cfg, inputs, targets,
                                _detach(state), True, ts.generator)
    grads = torch.autograd.grad(loss, ts.optimizer.params,
                                materialize_grads=True)
    ts.optimizer.update(grads)
    ts.step += 1
    return loss.detach(), _detach(final_state)


@torch.no_grad()
def lm_eval_loss(model: CharRNN, inputs: torch.Tensor, targets: torch.Tensor,
                 state: LMState, cfg: LMConfig
                 ) -> Tuple[torch.Tensor, LMState]:
    """(mean CE, final state) without dropout."""
    return lm_loss(model, cfg, inputs, targets, state)


@torch.no_grad()
def sample_seq(model: CharRNN, cfg: LMConfig, length: int,
               start_ids: Sequence[int],
               generator: Optional[torch.Generator] = None,
               temperature: float = 1.0, max_prob: bool = True) -> List[int]:
    """Greedy / temperature sampling (lang/char_rnn_model.py:246-282): warm
    up on start_ids, then emit `length` ids.  `generator` (on the model's
    device; default seed 0) draws the first id without start_ids and every
    id when not max_prob."""
    dev = model.softmax.weight.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    state = zero_state(cfg, 1, dev)
    ids = lambda i: torch.tensor([i], dtype=torch.long, device=dev)
    if start_ids:
        for sid in start_ids[:-1]:
            _, state = lm_step(model, cfg, ids(sid), state)
        x = ids(start_ids[-1])
    else:
        x = torch.randint(cfg.vocab_size, (1,), generator=generator,
                          device=dev)
    out = []
    for _ in range(length):
        logits, state = lm_step(model, cfg, x, state)
        if max_prob:
            nxt = int(logits[0].argmax())
        else:
            nxt = int(torch.multinomial(
                torch.softmax(logits[0] / temperature, -1), 1,
                generator=generator))
        out.append(nxt)
        x = ids(nxt)
    return out


class BatchGenerator:
    """Cursor-based contiguous text batcher (lang/char_rnn_model.py:285-324):
    batch_size cursors spaced text_size//batch_size apart; next() returns
    (num_unrollings+1, batch_size) ids where row 0 repeats the previous
    call's last row."""

    def __init__(self, ids, batch_size: int, n_unrollings: int):
        import numpy as np
        self._ids = np.asarray(ids, np.int32)
        self._batch_size = batch_size
        self._n = n_unrollings
        segment = len(self._ids) // batch_size
        self._cursor = [offset * segment for offset in range(batch_size)]
        self._last = self._next_row()

    def _next_row(self):
        import numpy as np
        row = np.empty((self._batch_size,), np.int32)
        for b in range(self._batch_size):
            row[b] = self._ids[self._cursor[b]]
            self._cursor[b] = (self._cursor[b] + 1) % len(self._ids)
        return row

    def next(self):
        import numpy as np
        rows = [self._last]
        for _ in range(self._n):
            rows.append(self._next_row())
        self._last = rows[-1]
        return np.stack(rows)  # (n_unrollings+1, batch_size)


def _best_model_dir(directory: str) -> str:
    return os.path.join(directory, "lang", "best_model")


def save_lm_dir(directory: str, model: CharRNN, cfg: LMConfig,
                epoch: int = 1) -> None:
    """Write an LM directory holding `model` as its best model (`epoch`),
    with the fixed 28-token char vocabulary (utils/text.lm_vocab)."""
    v2i, _, vocab_size = lm_vocab()
    if cfg.vocab_size != vocab_size:
        raise ValueError(f"LM vocab_size {cfg.vocab_size} != the "
                         f"{vocab_size}-token char vocabulary")
    os.makedirs(directory, exist_ok=True)
    vocab_file = os.path.join(directory, "vocab.json")
    with open(vocab_file, "w") as f:
        json.dump(v2i, f, indent=2)
    CheckpointManager(_best_model_dir(directory), max_to_keep=1) \
        .save_weights(epoch, model)
    result = {"params": dataclasses.asdict(cfg), "vocab_file": vocab_file,
              "best_model": epoch}
    with open(os.path.join(directory, "result.json"), "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)


def load_lm_dir(directory: str, epoch: int = -1,
                device: Union[str, torch.device] = "cpu"
                ) -> Tuple[CharRNN, LMConfig, Dict[str, int], Dict[int, str]]:
    """(model, cfg, v2i, i2v) from an LM directory: the given epoch, else
    result.json's best model, else the latest (sample_lm.load_lm)."""
    with open(os.path.join(directory, "result.json")) as f:
        result = json.load(f)
    cfg = LMConfig.from_json(json.dumps(result["params"]))
    with open(os.path.join(directory, "vocab.json")) as f:
        v2i = json.load(f)
    i2v = {int(i): c for c, i in v2i.items()}
    model = CharRNN(cfg)
    ckpt = CheckpointManager(_best_model_dir(directory))
    use_epoch = epoch if epoch >= 0 else result.get("best_model", -1)
    restored = ckpt.load_weights(
        model, epoch=use_epoch if use_epoch is not None else -1)
    if restored is None:
        restored = ckpt.load_weights(model, epoch=-1)
    if restored is None:
        raise FileNotFoundError(f"no LM checkpoint in {directory}")
    return model.to(device).eval(), cfg, v2i, i2v
