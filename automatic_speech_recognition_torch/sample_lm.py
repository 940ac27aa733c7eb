"""Sample text from, or compute perplexity with, a trained char RNNLM
(counterpart of the repository's sample_lm.py, on the same flags).

    python -m automatic_speech_recognition_torch.sample_lm --init_dir <lm> \\
        [--evaluate] [--device cuda]

Loads the LM directory train_lm writes (result.json, vocab.json,
lang/best_model/) through models/char_rnn.load_lm_dir, the best model or
--model_epoch, then either samples --length characters after --start_text
(greedy by default; --no_max_prob draws at --temperature from a generator
seeded with --seed) or, with --evaluate, prints the perplexity of
--example_text.

Tiny CPU run:
  python -m automatic_speech_recognition_torch.sample_lm --device cpu \\
      --init_dir /tmp/lm --length 20
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .models import char_rnn
from .utils.device import disable_tf32, resolve_device, split_device

log = logging.getLogger("sample_lm")


def load_lm(init_dir: str, epoch: int = -1,
            device: Union[str, torch.device] = "cpu"
            ) -> Tuple[char_rnn.CharRNN, char_rnn.LMConfig, Dict[str, int],
                       Dict[int, str]]:
    """(model, cfg, v2i, i2v) from a train_lm output directory."""
    return char_rnn.load_lm_dir(init_dir, epoch, device)


def main(argv: Optional[Sequence[str]] = None):
    """Returns the perplexity with --evaluate, else the sampled text."""
    device_name, argv = split_device(argv)
    p = argparse.ArgumentParser("char RNNLM sampler/evaluator (PyTorch)")
    p.add_argument("--init_dir", type=str, default="lang/output")
    p.add_argument("--model_epoch", type=int, default=-1)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--max_prob", action="store_true", default=True)
    p.add_argument("--no_max_prob", dest="max_prob", action="store_false")
    p.add_argument("--start_text", type=str, default="THE MEANING OF LIFE IS ")
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--example_text", type=str,
                   default="THE MEANING OF LIFE IS GOOD.")
    args = p.parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    device = resolve_device(device_name)
    if device.type == "cuda":
        disable_tf32()

    model, cfg, v2i, i2v = load_lm(args.init_dir, args.model_epoch, device)

    if args.evaluate:
        ids = torch.tensor([v2i[c] for c in args.example_text if c in v2i],
                           dtype=torch.long, device=device)
        loss, _ = char_rnn.lm_eval_loss(model, ids[None, :-1], ids[None, 1:],
                                        char_rnn.zero_state(cfg, 1, device),
                                        cfg)
        ppl = float(np.exp(float(loss)))
        print(f"Example text is: {args.example_text}")
        print(f"Perplexity is: {ppl}")
        return ppl

    start_ids = [v2i[c] for c in args.start_text if c in v2i]
    generator = torch.Generator(device=device).manual_seed(
        args.seed if args.seed >= 0 else 0)
    out = char_rnn.sample_seq(model, cfg, args.length, start_ids,
                              generator=generator,
                              temperature=args.temperature,
                              max_prob=args.max_prob)
    sample = args.start_text + "".join(i2v[i] for i in out)
    print(f"Sampled text is:\n{sample}")
    return sample


if __name__ == "__main__":
    main()
