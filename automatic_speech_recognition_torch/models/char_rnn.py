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
  as in models/las.py.

An LM directory has the layout train_lm.py writes and sample_lm.load_lm
reads: result.json ({"params": LMConfig fields, "best_model": epoch,
...}), vocab.json (char -> id) and lang/best_model/<epoch>.pt, the last in
the port's checkpoint format (training/checkpoint.py).  Training
(lm_train_step, BatchGenerator) and sampling (sample_seq) are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from automatic_speech_recognition_torch.utils.text import lm_vocab

from ..ops import layers as L
from ..training.checkpoint import CheckpointManager

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
        x = F.embedding(safe, model.embedding.weight)
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
