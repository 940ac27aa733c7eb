"""Training and evaluation steps (counterpart of
automatic_speech_recognition_tpu/training/trainer.py).  Only the greedy
evaluation forward is ported so far."""

from __future__ import annotations

from typing import Tuple

import torch

from automatic_speech_recognition_tpu.config import Config
from automatic_speech_recognition_tpu.utils.tokenizer import EOS_ID

from ..models.las import LAS


@torch.inference_mode()
def eval_forward(model: LAS, audio: torch.Tensor, audiolen: torch.Tensor,
                 cfg: Config, dec_steps: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy inference forward.  Returns (logits, y_hat)."""
    logits, _, _ = model(audio, audiolen, dec_steps)
    y_hat = logits.argmax(-1)
    if cfg.greedy_eos_margin >= 0:
        # cut at the first step whose EOS logit is within the margin of the
        # best content token (PAD, SOS and EOS excluded); detokenization
        # stops at the first EOS, earlier steps keep their argmax
        best_other = logits[..., EOS_ID + 1:].max(-1).values
        y_hat = torch.where(
            logits[..., EOS_ID] >= best_other - cfg.greedy_eos_margin,
            EOS_ID, y_hat)
    return logits, y_hat
