"""Batched beam search with optional char-RNNLM shallow fusion and joint
CTC prefix scoring (counterpart of
automatic_speech_recognition_tpu/decoding/beam.py, same semantics).

All B utterances x K beams run in one step loop: decoder states
(L, B*K, U), the listener output and the attention's encoder projection
expanded over K, the location conv shared by every row.  Per utterance,
as the JAX package's vmapped `_beam_search_single` does:

- scores accumulate raw decoder logits (the reference), or log-softmax
  with logprob=True;
- step 0 expands beam 0 only (the K initial beams are copies); <SOS>
  re-emission costs NEG after step 0;
- LM fusion: logits[:, 2:] += lm_weight * LM logits of the ids - 2;
- joint CTC (cfg.ctc_beam_weight w > 0, logprob only): the step score is
  (1 - w) logP_att + w dPsi, dPsi from decoding/ctc_prefix.py;
- EOS end detection (cfg.beam_eos_margin >= 0): EOS competes only within
  the margin of the best token other than PAD, SOS and EOS;
- with K > TOP_EXPANSIONS each beam keeps its TOP_EXPANSIONS best tokens;
- one top-K over the utterance's K * V candidates; hypotheses ending in
  EOS retire into a bank of K, ranked by score / length divisor plus the
  coverage terms (cfg.beam_coverage_penalty, cfg.beam_coverage_reward);
- an utterance stops when its bank holds K hypotheses or after
  dec_step = int32(float32(featlen) * convert_rate) steps, clamped to
  [1, max_steps] and computed in float32 as JAX does; its beams still
  live then join the bank, with their coverage terms.

Under cfg.dtype 'bfloat16' the model runs in models/las.compute_cast:
the decoder states and the previous alignment are carried in bfloat16,
the logits, the LM add (the LM stays float32), the CTC log-probs, the
cumulative scores and the bank in float32, as the JAX package's carry.

Frozen rows: a vmapped while_loop steps until every utterance is done
and leaves the carry of a finished utterance unchanged.  Here every carry
update is masked per utterance with active = (t < dec_step) &
(n_finished < K), so a short utterance's step count, bank and live beams
stop where its own search stopped.  The loop reads `active.any()` on the
host once per step.

Spans (utils/spans.py): `beam.search` around a batch, the counter
`beam.steps`, and fine ranges `beam.step.attention`,
`beam.step.ctc_prefix` and `beam.step.topk` under a profiler.
step_scores=True keeps each hypothesis's per-step terms beside its
tokens (StepScores), so a search can be held step by step.

Ties: every top-K is a stable descending sort, so among equal scores the
lower index comes first (lower beam, then lower token id; the bank before
the new hypotheses), which is jax.lax.top_k's rule, on the CPU and on
CUDA alike.  `prune_expansions` keeps every entry >= the k-th largest,
ties included.  A slot with no real candidate scores NEG + x == NEG in
float32, so such slots tie exactly; only ranks whose score is > NEG / 2
are hypotheses (Recognizer reads rank 0).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import torch

from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.utils.tokenizer import (EOS_ID, PAD_ID,
                                                               SOS_ID)

from ..models import char_rnn, las
from ..models.las import LAS
from ..ops import attention as att
from ..ops import layers as L
from ..utils import spans
from . import ctc_prefix

log = logging.getLogger("beam")

NEG = -1.0e30
# per-beam expansion budget before the top-K (las/beam_search.py:123)
TOP_EXPANSIONS = 64


class StepScores(NamedTuple):
    """Each kept hypothesis's terms a step, (B, K, max_steps) float32,
    valid for its first `lengths` steps: the attention decoder's score of
    the token it took (the log-prob with logprob=True, after LM fusion),
    and with joint CTC the prefix score's increment dPsi (None without).
    Its score is sum_t ((1 - w) attention + w ctc_prefix) over the length
    divisor, plus the coverage terms."""
    attention: torch.Tensor
    ctc_prefix: Optional[torch.Tensor]


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, K, max_steps) generated ids (EOS included)
    lengths: torch.Tensor  # (B, K) generated token counts
    scores: torch.Tensor   # (B, K) length-normalized scores, best first
    steps: int             # decoder steps run: the last utterance's stop
    step_scores: Optional[StepScores] = None   # beam_search(step_scores=True)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis; ties go to
    the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def prune_expansions(step_scores: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's entries >= its k-th largest (ties included), mask
    the rest to NEG; the identity when k >= the row width."""
    if k >= step_scores.shape[-1]:
        return step_scores
    kth = torch.topk(step_scores, k, dim=-1).values[..., -1:]
    return torch.where(step_scores >= kth, step_scores, NEG)


def _length_div(cfg: Config, length: torch.Tensor) -> torch.Tensor:
    """Divisor for length-normalized ranking: the length itself
    (beam_len_penalty < 0, the reference), else the GNMT
    ((5 + len) / 6) ** alpha; float32."""
    length = length.to(torch.float32)
    if cfg.beam_len_penalty < 0:
        return length
    return ((5.0 + length) / 6.0) ** cfg.beam_len_penalty


def _coverage(cfg: Config, cum_align: torch.Tensor,
              real_frames: torch.Tensor) -> torch.Tensor:
    """Coverage terms of summed alignments (B, K, T) over real frames
    (B, 1, T): GNMT beta * sum_j log(min(c_j, 1)) and/or the Chorowski
    count reward beta * |{j : c_j > tau}|."""
    out = torch.zeros(cum_align.shape[:-1], device=cum_align.device)
    if cfg.beam_coverage_penalty > 0:
        cov = torch.log(cum_align.clamp(1e-8, 1.0))
        out = out + cfg.beam_coverage_penalty * torch.where(
            real_frames, cov, 0.0).sum(-1)
    if cfg.beam_coverage_reward > 0:
        hit = real_frames & (cum_align > cfg.beam_coverage_tau)
        out = out + cfg.beam_coverage_reward * hit.to(torch.float32).sum(-1)
    return out


def step_budget(featlen: torch.Tensor, cfg: Config,
                max_steps: int) -> torch.Tensor:
    """dec_step = int32(float32(featlen) * convert_rate), clamped to
    [1, max_steps]: float32 as in JAX, since float64 truncates to another
    step count at some lengths."""
    return (featlen.to(torch.float32) * cfg.convert_rate
            ).to(torch.int32).clamp(1, max_steps)


def _map_state(fn, *states):
    """fn over the matching tensors of LM states (tuples of tensors or of
    (c, h) pairs)."""
    if isinstance(states[0], torch.Tensor):
        return fn(*states)
    return tuple(_map_state(fn, *xs) for xs in zip(*states))


@torch.inference_mode()
def beam_search(model: LAS, feats: torch.Tensor, featlen: torch.Tensor,
                cfg: Config, max_steps: int, beam_size: int = 8,
                logprob: bool = False,
                lm: Optional[char_rnn.CharRNN] = None,
                lm_cfg: Optional[char_rnn.LMConfig] = None,
                step_scores: bool = False) -> BeamResult:
    """Batched beam decode: (B, T, D, 3) features -> BeamResult.

    max_steps bounds the search (convert_rate * padded frames); each
    utterance's own budget is convert_rate * featlen.  step_scores=True
    also returns each kept hypothesis's terms a step (StepScores)."""
    use_cov = cfg.beam_coverage_penalty > 0 or cfg.beam_coverage_reward > 0
    if use_cov and not logprob:
        log.warning("coverage scoring is tuned for log-prob scoring; "
                    "consider --beam_logprob True")
    sp = model.speller
    use_ctc = cfg.ctc_beam_weight > 0
    if use_ctc and not logprob:
        raise ValueError(
            "joint CTC decoding (ctc_beam_weight > 0) mixes log "
            "probabilities; raw-logit scoring is meaningless there — "
            "pass --beam_logprob True")
    if use_ctc and sp.ctc_head is None:
        raise ValueError(
            "ctc_beam_weight > 0 needs a checkpoint trained with "
            "--ctc True (no ctc_head in the restored parameters)")

    with las.compute_cast(cfg, model), spans.span("beam.search"):
        return _beam_search(model, feats, featlen, cfg, max_steps, beam_size,
                            logprob, lm, lm_cfg, use_ctc, use_cov,
                            step_scores)


def _extend(hist: torch.Tensor, rows, parent, s: int, value) -> torch.Tensor:
    """The children's histories: each parent's, with step s set."""
    new = hist[rows, parent]
    new[..., s] = value
    return new


def _beam_search(model: LAS, feats, featlen, cfg: Config, max_steps: int,
                 beam_size: int, logprob: bool, lm, lm_cfg, use_ctc: bool,
                 use_cov: bool, keep_terms: bool) -> BeamResult:
    sp = model.speller
    use_lm = lm is not None
    cdt = las.compute_dtype(cfg)
    enc_out, enc_len = model.listener(feats.to(cdt), featlen)
    dec_step = step_budget(featlen, cfg, max_steps)
    B, T, _ = enc_out.shape
    K, V = beam_size, cfg.vocab_size
    BK = B * K
    dev = enc_out.device
    rows = torch.arange(B, device=dev)[:, None]
    enc_k = enc_out.repeat_interleave(K, 0)              # row b * K + k
    enc_len_k = enc_len.repeat_interleave(K, 0)
    h_proj_k = att.precompute_hidden(sp.attention,
                                     enc_out).repeat_interleave(K, 0)
    real_frames = (torch.arange(T, device=dev) < enc_len[:, None])[:, None]
    # EOS end detection competes against every token but these
    control_ids = torch.tensor([PAD_ID, SOS_ID, EOS_ID], device=dev)
    if use_ctc:
        w = float(cfg.ctc_beam_weight)
        ctc_x = ctc_prefix.masked_logp(
            torch.log_softmax(sp.ctc_head(enc_out).float(), -1), enc_len)
        ctc_r = ctc_prefix.init_state(ctc_x)[:, None].expand(B, K, T, 2)
        ctc_psi = torch.zeros((B, K), device=dev)

    i64 = dict(dtype=torch.long, device=dev)
    t = torch.zeros((B,), **i64)
    prev_ids = torch.full((B, K), SOS_ID, **i64)
    prev_align = torch.zeros((B, K, T), dtype=cdt, device=dev)
    dec_states = torch.zeros((len(sp.cells), BK, sp.state_size),
                             dtype=cdt, device=dev)
    cum = torch.zeros((B, K), device=dev)
    valid = (torch.arange(K, device=dev) == 0).expand(B, K)
    tokens = torch.zeros((B, K, max_steps), **i64)
    bank_tokens = torch.zeros((B, K, max_steps), **i64)
    bank_len = torch.zeros((B, K), **i64)
    bank_score = torch.full((B, K), NEG, device=dev)
    n_finished = torch.zeros((B,), **i64)
    lm_states = char_rnn.zero_state(lm_cfg, BK, dev) if use_lm else None
    cum_align = torch.zeros((B, K, T), device=dev)
    # per-step terms of the live beams and of the bank (StepScores)
    terms = bank_terms = None
    if keep_terms:
        terms = [torch.zeros((B, K, max_steps), device=dev)
                 for _ in range(1 + use_ctc)]
        bank_terms = [torch.zeros_like(x) for x in terms]

    steps = 0
    for s in range(max_steps):
        active = (t < dec_step) & (n_finished < K)
        if not bool(active.any()):                        # host sync
            break
        steps = s + 1
        with spans.fine("beam.step.attention"):
            logits, new_states, alphas = las.decode_step(
                sp, enc_k, enc_len_k, dec_states,
                L.embed(sp.embedding, prev_ids.reshape(BK)),
                prev_align.reshape(BK, T), h_proj_k)
            logits = logits.float()
        if use_lm:
            lm_logits, new_lm = char_rnn.lm_step(
                lm, lm_cfg, prev_ids.reshape(BK) - 2, lm_states)
            logits[:, 2:] += cfg.lm_weight * lm_logits
        step_scores = (torch.log_softmax(logits, -1) if logprob
                       else logits).reshape(B, K, V)
        att_scores = step_scores
        if use_ctc:
            # at step 0 the prefix is empty: no token can be a repeat
            last_ids = prev_ids if s > 0 else torch.full_like(prev_ids, -1)
            with spans.fine("beam.step.ctc_prefix"):
                psi_delta, r_all, psi_all = ctc_prefix.step(
                    ctc_x, ctc_r, ctc_psi, last_ids, s == 0)
            step_scores = (1.0 - w) * step_scores + w * psi_delta
        if cfg.beam_eos_margin >= 0:
            best_other = step_scores.index_fill(-1, control_ids,
                                                NEG).amax(-1)
            eos_score = step_scores[..., EOS_ID]
            step_scores = step_scores.clone()
            step_scores[..., EOS_ID] = torch.where(
                eos_score >= best_other - cfg.beam_eos_margin, eos_score, NEG)
        if K > TOP_EXPANSIONS:
            # only then can pruning change the top-K selection
            step_scores = prune_expansions(step_scores, TOP_EXPANSIONS)

        with spans.fine("beam.step.topk"):
            cand = torch.where(valid[..., None],
                               cum[..., None] + step_scores, NEG)
            if s > 0:
                cand[..., SOS_ID] += NEG
            scores, flat_idx = _top_k(cand.reshape(B, K * V), K)
        parent, tok = flat_idx // V, flat_idx % V
        flat_parent = (rows * K + parent).reshape(BK)
        new_tokens = _extend(tokens, rows, parent, s, tok)
        # a slot is real iff it descends from an actual candidate
        real = scores > NEG * 0.5
        eos = (tok == EOS_ID) & real
        norm = scores / _length_div(cfg, torch.tensor(s + 1))
        alphas = alphas.reshape(B, K, T)[rows, parent]
        if use_cov:
            # a child's attention history: the parent's plus the alignment
            # the parent just consumed producing this token
            new_cum_align = cum_align[rows, parent] + alphas.float()
            norm = norm + _coverage(cfg, new_cum_align, real_frames)
        cat_scores = torch.cat([bank_score, torch.where(eos, norm, NEG)], 1)
        cat_tokens = torch.cat([bank_tokens, new_tokens], 1)
        cat_len = torch.cat([bank_len, torch.full((B, K), s + 1, **i64)], 1)
        new_bank_score, bidx = _top_k(cat_scores, K)
        if terms is not None:
            picked = [att_scores] + ([psi_delta] if use_ctc else [])
            new_terms = [_extend(h, rows, parent, s, x[rows, parent, tok])
                         for h, x in zip(terms, picked)]

        # commit, leaving the carry of a stopped utterance frozen
        a1, a2 = active[:, None], active[:, None, None]
        a_rows = active.repeat_interleave(K)[:, None]     # (BK, 1)
        t = torch.where(active, t + 1, t)
        prev_ids = torch.where(a1, tok, prev_ids)
        prev_align = torch.where(a2, alphas, prev_align)
        dec_states = torch.where(a_rows, new_states[:, flat_parent],
                                 dec_states)
        cum = torch.where(a1, torch.where(eos, NEG, scores), cum)
        valid = torch.where(a1, ~eos & real, valid)
        tokens = torch.where(a2, new_tokens, tokens)
        bank_tokens = torch.where(a2, cat_tokens[rows, bidx], bank_tokens)
        bank_len = torch.where(a1, cat_len[rows, bidx], bank_len)
        bank_score = torch.where(a1, new_bank_score, bank_score)
        n_finished = torch.where(active, n_finished + eos.sum(1), n_finished)
        if use_lm:
            lm_states = _map_state(
                lambda new, old: torch.where(a_rows, new[flat_parent], old),
                new_lm, lm_states)
        if use_ctc:
            ctc_r = torch.where(active[:, None, None, None],
                                r_all[rows, parent, tok], ctc_r)
            ctc_psi = torch.where(a1, psi_all[rows, parent, tok], ctc_psi)
        if use_cov:
            cum_align = torch.where(a2, new_cum_align, cum_align)
        if terms is not None:
            bank_terms = [torch.where(a2, torch.cat([b, n], 1)[rows, bidx], b)
                          for b, n in zip(bank_terms, new_terms)]
            terms = [torch.where(a2, n, o) for n, o in zip(new_terms, terms)]
    spans.count("beam.steps", steps)

    # step budget exhausted: still-live beams join the bank
    # (las/beam_search.py:155-156)
    exhausted = (t >= dec_step)[:, None] & valid
    live = cum / _length_div(cfg, t.clamp(min=1))[:, None]
    if use_cov:
        live = live + _coverage(cfg, cum_align, real_frames)
    cat_scores = torch.cat([bank_score, torch.where(exhausted, live, NEG)], 1)
    cat_tokens = torch.cat([bank_tokens, tokens], 1)
    cat_len = torch.cat([bank_len, t[:, None].expand(B, K)], 1)
    final_score, idx = _top_k(cat_scores, K)
    kept = None
    if terms is not None:
        kept = [torch.cat([b, h], 1)[rows, idx]
                for b, h in zip(bank_terms, terms)]
        kept = StepScores(kept[0], kept[1] if use_ctc else None)
    return BeamResult(cat_tokens[rows, idx], cat_len[rows, idx], final_score,
                      steps, kept)
