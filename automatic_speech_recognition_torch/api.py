"""Inference API: waveforms or audio files -> transcripts (counterpart of
automatic_speech_recognition_tpu/api.py).

    rec = Recognizer.from_checkpoint(save_dir, cfg, lm_dir=lm_dir)
    texts = rec.transcribe(["a.flac", "b.wav"], beam_size=8)
    texts = rec.transcribe_signals([sig_a, sig_b])          # greedy

The path: pad to a whole second -> frontend (the fused CUDA kernel on a
GPU, the plain path on the CPU) -> greedy LAS, or batched beam search
(decoding/beam.py, with the recognizer's fusion LM and cfg's beam flags)
-> detokenization of rank 0.  cfg.dtype 'bfloat16' decodes in bf16
(models/las.compute_cast); cfg.quantize_decoder 'int8' quantizes the
restored float checkpoint's speller and the fusion LM's cells
(ops/quant.py).

A comma list of devices ('cuda:0,cuda:1') is a data axis, as the JAX
Recognizer's mesh over jax.devices(): a replica of the model and the LM
on each (parallel/sharding.py); a request batch is padded to a multiple
of the devices with 1-sample silence, featurized on the first, its rows
decoded on the replicas at once and gathered in order.  'cuda' is one
GPU, as 'cuda:N' is: replicas on threads of one process measured slower
than one device (PERF.md, Findings).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.data.audio_io import read_audio
from automatic_speech_recognition_torch.utils.text import convert_idx_to_string
from automatic_speech_recognition_torch.utils.tokenizer import get_tokenizer

from .decoding import beam as beam_lib
from .models import char_rnn
from .models.las import LAS
from .ops import frontend, quant
from .parallel import sharding
from .parallel.mesh import devices_for, make_mesh
from .training import trainer
from .training.checkpoint import CheckpointManager


class Recognizer:
    """LAS model + config + tokenizer (+ optional fusion LM) over the
    devices `device` names (parallel/mesh.devices_for): `model` and `lm`
    on the first, a replica of each on every other."""

    def __init__(self, model: LAS, cfg: Config, tokenizer, device,
                 lm: Optional[char_rnn.CharRNN] = None,
                 lm_cfg: Optional[char_rnn.LMConfig] = None):
        self.mesh = make_mesh(devices=devices_for(str(device)),
                              data_axis=cfg.data_axis,
                              model_axis=cfg.model_axis)
        self.device = self.mesh.devices[0]
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lm = lm.to(self.device).eval() if lm is not None else None
        self.lm_cfg = lm_cfg
        self.replicas = sharding.place_eval_params(self.mesh, self.model,
                                                   self.lm)

    @classmethod
    def from_checkpoint(cls, save_dir: str, cfg: Config, epoch: int = -1,
                        lm_dir: str = "",
                        device: Union[str, torch.device] = "cuda"
                        ) -> "Recognizer":
        """The port's LAS checkpoint in save_dir (epoch -1 = latest) and,
        with lm_dir, the fusion LM of that LM directory; both quantized
        under cfg.quantize_decoder 'int8'."""
        tokenizer = get_tokenizer(cfg.unit, cfg.subword_dir)
        cfg = cfg.replace(vocab_size=tokenizer.get_vocab_size())
        model = CheckpointManager(save_dir).load_weights(LAS(cfg), epoch)
        if model is None:
            raise FileNotFoundError(f"no checkpoint in {save_dir}")
        model = quant.maybe_quantize(model, cfg)
        lm = lm_cfg = None
        if lm_dir:
            lm, lm_cfg, _, _ = char_rnn.load_lm_dir(lm_dir)
            if cfg.quantize_decoder != "none":
                lm = quant.quantize_lm(lm, lm_cfg)
        return cls(model, cfg, tokenizer, device, lm, lm_cfg)

    def _features(self, signals: Sequence[np.ndarray], pad_seconds: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad to a whole number of seconds, at least pad_seconds (the
        serving bucket), and featurize on the device."""
        maxlen = max(len(s) for s in signals)
        quantum = self.cfg.sample_rate
        S = max(-(-maxlen // quantum), pad_seconds) * quantum
        audio = np.zeros((len(signals), S), np.float32)
        lens = np.zeros((len(signals),), np.int32)
        for i, s in enumerate(signals):
            audio[i, :len(s)] = s
            lens[i] = len(s)
        return frontend.extract_features_cfg(
            torch.from_numpy(audio).to(self.device),
            torch.from_numpy(lens).to(self.device), self.cfg)

    def greedy(self, feats: torch.Tensor, featlen: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, y_hat) for a feature batch whose rows divide by the
        devices, max_steps from its length."""
        steps = self.max_steps(feats)
        return sharding.run_replicas(
            self.mesh, self.replicas,
            lambda r, f, fl: trainer.eval_forward(r.model, f, fl, self.cfg,
                                                  steps),
            (feats, featlen))

    def beam(self, feats: torch.Tensor, featlen: torch.Tensor,
             beam_size: int) -> beam_lib.BeamResult:
        """Beam search over a feature batch (rows dividing by the devices)
        with cfg's beam flags and the recognizer's LM."""
        steps = self.max_steps(feats)
        return sharding.run_replicas(
            self.mesh, self.replicas,
            lambda r, f, fl: beam_lib.beam_search(
                r.model, f, fl, self.cfg, steps, beam_size,
                self.cfg.beam_logprob, r.lm, self.lm_cfg),
            (feats, featlen))

    def max_steps(self, feats: torch.Tensor) -> int:
        return max(int(self.cfg.convert_rate * feats.shape[1]), 1)

    def transcribe_signals(self, signals: Sequence[np.ndarray],
                           beam_size: int = 0,
                           pad_seconds: int = 0) -> List[str]:
        """signals: float waveforms at cfg.sample_rate.  beam_size 0/1:
        greedy; > 1: beam search, rank 0."""
        n = len(signals)
        # rows of 1-sample silence make the batch divide by the devices;
        # their hypotheses are dropped below
        signals = list(signals) + [np.zeros(1, np.float32)] * (
            sharding.pad_batch_to(n, len(self.mesh.devices)) - n)
        feats, featlen = self._features(signals, pad_seconds)
        if beam_size > 1:
            res = self.beam(feats, featlen, beam_size)
            toks, tlen = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
            ids = [toks[i, 0, :tlen[i, 0]] for i in range(n)]
        else:
            _, y_hat = self.greedy(feats, featlen)
            ids = list(y_hat.cpu().numpy()[:n])
        return [convert_idx_to_string(x, self.tokenizer.id_to_token,
                                      self.cfg.unit) for x in ids]

    def transcribe(self, paths: Sequence[str], beam_size: int = 0,
                   batch_size: int = 8) -> List[str]:
        """Transcribe audio files (WAV/FLAC) in length-sorted batches,
        preserving input order."""
        signals = []
        for p in paths:
            sig, sr = read_audio(p)
            if sr != self.cfg.sample_rate:
                raise ValueError(
                    f"{p}: sample rate {sr} != {self.cfg.sample_rate}")
            signals.append(np.asarray(sig, np.float32))
        order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
        out: List[Optional[str]] = [None] * len(signals)
        for lo in range(0, len(order), batch_size):
            idx = order[lo:lo + batch_size]
            texts = self.transcribe_signals([signals[i] for i in idx],
                                            beam_size)
            for i, t in zip(idx, texts):
                out[i] = t
        return out  # type: ignore[return-value]
