"""Best-path CTC decoding of the auxiliary CTC head (counterpart of
automatic_speech_recognition_tpu/decoding/ctc.py): argmax per encoder
frame, collapse repeats, drop blanks (blank id = vocab_size, as in the
CTC loss) and <PAD> (id 0, which no label holds), over real frames only.
The listener and the head run in cfg's compute dtype
(models/las.compute_cast).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from automatic_speech_recognition_torch.config import Config

from ..models import las
from ..models.las import LAS


@torch.inference_mode()
def ctc_greedy_decode(model: LAS, feats: torch.Tensor, featlen: torch.Tensor,
                      cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, T_enc) int32 left-compacted and padded with 0,
    lengths (B,) int32)."""
    if model.speller.ctc_head is None:
        raise ValueError("CTC decoding needs a model trained with --ctc True "
                         "(no ctc_head)")
    with las.compute_cast(cfg, model):
        enc_out, enc_len = model.listener(feats.to(las.compute_dtype(cfg)),
                                          featlen)
        path = model.speller.ctc_head(enc_out).argmax(-1)        # (B, T)
    B, T = path.shape
    blank = cfg.vocab_size
    valid = (torch.arange(T, device=path.device)[None, :]
             < enc_len[:, None])
    prev = F.pad(path[:, :-1], (1, 0), value=blank)
    keep = (path != blank) & (path != prev) & (path != 0) & valid
    # kept symbol k goes to position (#kept before it); the rest to a
    # spill column that is cut off
    idx = torch.where(keep, keep.cumsum(1) - 1, T)
    tokens = torch.zeros((B, T + 1), dtype=path.dtype, device=path.device)
    tokens.scatter_(1, idx, path)
    return tokens[:, :T].to(torch.int32), keep.sum(1).to(torch.int32)
