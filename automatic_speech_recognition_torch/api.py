"""Inference API: waveforms -> transcripts (counterpart of
automatic_speech_recognition_tpu/api.py).

    rec = Recognizer(model, cfg, tokenizer, device)
    texts = rec.transcribe_signals([sig_a, sig_b])

The path: pad to a whole second -> frontend (the fused CUDA kernel on a
GPU, the plain path on the CPU) -> greedy LAS -> detokenization.  Beam
search and `from_checkpoint` are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from automatic_speech_recognition_tpu.config import Config
from automatic_speech_recognition_tpu.utils.text import convert_idx_to_string

from .models.las import LAS
from .ops import frontend
from .training import trainer
from .utils.device import resolve_device


class Recognizer:
    """LAS model + config + tokenizer on one device."""

    def __init__(self, model: LAS, cfg: Config, tokenizer, device):
        self.device = resolve_device(str(device))
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.tokenizer = tokenizer

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
        """(logits, y_hat) for a feature batch, max_steps from its length."""
        max_steps = max(int(self.cfg.convert_rate * feats.shape[1]), 1)
        return trainer.eval_forward(self.model, feats, featlen, self.cfg,
                                    max_steps)

    def transcribe_signals(self, signals: Sequence[np.ndarray],
                           beam_size: int = 0,
                           pad_seconds: int = 0) -> List[str]:
        """signals: float waveforms at cfg.sample_rate.  Greedy only."""
        if beam_size > 1:
            raise NotImplementedError("beam search is not ported yet")
        feats, featlen = self._features(signals, pad_seconds)
        _, y_hat = self.greedy(feats, featlen)
        y_hat = y_hat.cpu().numpy()
        return [convert_idx_to_string(y_hat[i], self.tokenizer.id_to_token,
                                      self.cfg.unit)
                for i in range(len(signals))]
