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

`device` names the devices as parallel/mesh.devices_for does: plain
'cuda' is every visible GPU (as the JAX Recognizer's mesh over
jax.devices()), 'cuda:N' one GPU, and a comma list ('cuda:0,cuda:1',
'cpu,cpu') a data axis over those.  cfg.num_partitions k splits each
replica column-wise over k consecutive devices (parallel/sharding.py),
so the data axis holds len / k replicas.  One replica runs inline in
this process, as on one GPU; more run one worker process each
(parallel/workers.EvalPool), started once when the Recognizer is made
and stopped by close() (or `with Recognizer(...)`).  Over several
replicas a request batch is padded to a multiple of them with 1-sample
silence and its rows split over them; each worker featurizes its own
rows of audio (the fused kernel on its own GPU: framing and CMVN are per
utterance at the batch's padded width, so this is the same result) and
decodes them, and the rows are gathered in order.  submit_signals
instead runs a whole batch on the next free replica, which is how the
batcher (serving.py) and transcribe / transcribe_all keep one batch in
flight per replica.
"""

from __future__ import annotations

import collections
from concurrent.futures import Future
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
from .parallel import sharding, workers
from .parallel.mesh import eval_mesh
from .training.checkpoint import CheckpointManager
from .utils import spans


class Recognizer:
    """LAS model + config + tokenizer (+ optional fusion LM) over the
    devices `device` names (parallel/mesh.eval_mesh): `model` and `lm`
    on the first, and `pool` (parallel/workers.EvalPool) holding a
    replica of both per run of cfg.num_partitions devices, inline for
    one, a worker process each for more."""

    def __init__(self, model: LAS, cfg: Config, tokenizer, device,
                 lm: Optional[char_rnn.CharRNN] = None,
                 lm_cfg: Optional[char_rnn.LMConfig] = None):
        self.mesh = eval_mesh(str(device), cfg.num_partitions,
                              cfg.data_axis, cfg.model_axis)
        self.device = self.mesh.devices[0]
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lm = lm.to(self.device).eval() if lm is not None else None
        self.lm_cfg = lm_cfg
        self.pool = workers.EvalPool(self.mesh, cfg, self.model, self.lm,
                                     lm_cfg)

    def close(self) -> None:
        """Stop the worker processes, if any."""
        self.pool.close()

    def __enter__(self) -> "Recognizer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

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

    def _audio(self, signals: Sequence[np.ndarray], pad_seconds: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(audio (B, S) float32, lens (B,) int32): zero-padded to a whole
        number of seconds, at least pad_seconds (the serving bucket)."""
        maxlen = max(len(s) for s in signals)
        quantum = self.cfg.sample_rate
        S = max(-(-maxlen // quantum), pad_seconds) * quantum
        audio = np.zeros((len(signals), S), np.float32)
        lens = np.zeros((len(signals),), np.int32)
        for i, s in enumerate(signals):
            audio[i, :len(s)] = s
            lens[i] = len(s)
        return audio, lens

    def _features(self, signals: Sequence[np.ndarray], pad_seconds: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad to a whole number of seconds, at least pad_seconds (the
        serving bucket), and featurize on the first device (a
        `recognizer.featurize` span, as workers.featurize)."""
        audio, lens = self._audio(signals, pad_seconds)
        with spans.span("recognizer.featurize"):
            return frontend.extract_features_cfg(
                torch.from_numpy(audio).to(self.device),
                torch.from_numpy(lens).to(self.device), self.cfg)

    def greedy(self, feats: torch.Tensor, featlen: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, y_hat) of the greedy speller for a feature batch whose
        rows divide by the replicas, max_steps from its length."""
        return self.pool.run_split("greedy", (feats, featlen),
                                   steps=self.max_steps(feats),
                                   decoder="attention")

    def beam(self, feats: torch.Tensor, featlen: torch.Tensor,
             beam_size: int) -> beam_lib.BeamResult:
        """Beam search over a feature batch (rows dividing by the
        replicas) with cfg's beam flags and the recognizer's LM."""
        return self.pool.run_split("beam", (feats, featlen),
                                   beam_size=beam_size,
                                   steps=self.max_steps(feats))

    def max_steps(self, feats: torch.Tensor) -> int:
        return max(int(self.cfg.convert_rate * feats.shape[1]), 1)

    def _texts(self, out, n: int, beam_size: int) -> List[str]:
        """The first n rows' hypotheses of a greedy (logits, y_hat) or a
        beam result (rank 0)."""
        if beam_size > 1:
            toks, tlen = out.tokens.cpu().numpy(), out.lengths.cpu().numpy()
            ids = [toks[i, 0, :tlen[i, 0]] for i in range(n)]
        else:
            ids = list(out[1].cpu().numpy()[:n])
        return [convert_idx_to_string(x, self.tokenizer.id_to_token,
                                      self.cfg.unit) for x in ids]

    def _raw_op(self, beam_size: int) -> Tuple[str, dict]:
        if beam_size > 1:
            return "featurize_then_beam", {"beam_size": beam_size}
        return "featurize_then_greedy", {"decoder": "attention",
                                         "logits": False}

    def transcribe_signals(self, signals: Sequence[np.ndarray],
                           beam_size: int = 0,
                           pad_seconds: int = 0) -> List[str]:
        """signals: float waveforms at cfg.sample_rate.  beam_size 0/1:
        greedy; > 1: beam search, rank 0.  The rows are split over the
        replicas, each featurizing and decoding its own."""
        n = len(signals)
        # rows of 1-sample silence make the batch divide by the replicas;
        # their hypotheses are dropped
        signals = list(signals) + [np.zeros(1, np.float32)] * (
            sharding.pad_batch_to(n, self.pool.size) - n)
        op, kw = self._raw_op(beam_size)
        out = self.pool.run_split(op, self._audio(signals, pad_seconds), **kw)
        return self._texts(out, n, beam_size)

    def submit_signals(self, signals: Sequence[np.ndarray],
                       beam_size: int = 0, pad_seconds: int = 0,
                       worker: Optional[int] = None) -> Future:
        """The whole batch on one replica, `worker` or the next free one:
        a Future of transcribe_signals' texts (done when it returns, for
        an inline replica)."""
        op, kw = self._raw_op(beam_size)
        inner = self.pool.submit(op, self._audio(signals, pad_seconds),
                                 worker=worker, **kw)
        return workers.then(inner, lambda out: self._texts(
            out, len(signals), beam_size))

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
        return self.transcribe_all(signals, beam_size, batch_size)

    def transcribe_all(self, signals: Sequence[np.ndarray],
                       beam_size: int = 0, batch_size: int = 8
                       ) -> List[str]:
        """Waveforms in length-sorted batches, each whole batch on the
        next free replica with one in flight per replica (test.py's
        loop), texts in input order."""
        order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
        out: List[Optional[str]] = [None] * len(signals)
        inflight: collections.deque = collections.deque()

        def collect() -> None:
            idx, fut = inflight.popleft()
            for i, t in zip(idx, fut.result()):
                out[i] = t

        for lo in range(0, len(order), batch_size):
            idx = order[lo:lo + batch_size]
            inflight.append((idx, self.submit_signals(
                [signals[i] for i in idx], beam_size)))
            if len(inflight) >= self.pool.size:
                collect()
        while inflight:
            collect()
        return out  # type: ignore[return-value]
