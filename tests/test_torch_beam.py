"""Port beam search (automatic_speech_recognition_torch/decoding/beam.py)
against the JAX package's decoding/beam.beam_search on converted weights
and the same NumPy features.

Held equal: the rank-0 tokens and length of every utterance, and which
ranks hold a hypothesis (score > NEG / 2).  Held close: the scores of
those ranks, rtol 1e-4 / atol 1e-6 (float32 on both sides, sums in
another order).  Ranks without a hypothesis tie at NEG and are not
compared.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.decoding import beam as jbeam
from automatic_speech_recognition_tpu.models import char_rnn as jcr
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.decoding import beam as tbeam
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.training import trainer

from test_torch_las import jax_cfg, jax_model

CPU = torch.device("cpu")
# tests/test_beam_search.py's width, location attention, T <= 32 frames
CFG = Config(unit="char", vocab_size=12, feat_dim=8, enc_type="cnn",
             enc_units=12, num_enc_channels=4, num_enc_layers=1,
             dec_units=12, num_dec_layers=2, embedding_size=8,
             attention_size=8, mode="loc", loc_kernel_size=5,
             loc_num_channels=2, dropout_rate=0.0, scheduled_sampling=False,
             apply_bn=False, convert_rate=0.3)
T = 32


def lm_pair(cfg, model="lstm", emb=0, seed=7):
    """A fusion LM over the LAS vocab minus <PAD>, <SOS>: JAX params and
    the port's converted copy."""
    kw = dict(vocab_size=cfg.vocab_size - 2, hidden_size=8,
              embedding_size=emb, num_layers=2, model=model)
    jcfg, tcfg = jcr.LMConfig(**kw), tcr.LMConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(seed), jcfg))
    return (params, jcfg), (convert.from_jax_lm_params(params, tcfg, CPU),
                            tcfg)


def run_both(cfg, K, logprob, seed=0, lens=(32, 23), lm=None,
             eos_bias=0.0):
    """Decode the same batch with JAX and the port; returns the two
    BeamResults as NumPy, after checking them against each other, and the
    port's step count."""
    rng = np.random.default_rng(seed)
    params, state = jax_model(cfg, rng, seed)
    params["speller"]["out"]["b"][2] += eos_bias
    lens = np.asarray(lens, np.int32)
    x = rng.standard_normal((len(lens), T, cfg.feat_dim, 3)).astype(
        np.float32)
    max_steps = max(int(cfg.convert_rate * T), 1)
    (jlm, jlm_cfg), (tlm, tlm_cfg) = lm if lm else ((None, None),) * 2
    want = jbeam.beam_search(params, state, x, lens, jax_cfg(cfg), max_steps=max_steps,
                             beam_size=K, logprob=logprob, lm_params=jlm,
                             lm_cfg=jlm_cfg)
    got = tbeam.beam_search(convert.from_jax_params(params, state, cfg, CPU),
                            torch.from_numpy(x), torch.from_numpy(lens), cfg,
                            max_steps, K, logprob, tlm, tlm_cfg)
    want = [np.asarray(a) for a in want]
    steps = got.steps
    assert 1 <= steps <= max_steps
    got = [a.numpy() for a in got[:3]]
    (wt, wl, ws), (gt, gl, gs) = want, got
    real = ws > jbeam.NEG / 2
    np.testing.assert_array_equal(gs > tbeam.NEG / 2, real)
    np.testing.assert_array_equal(gl[:, 0], wl[:, 0])
    for b in range(len(lens)):
        np.testing.assert_array_equal(gt[b, 0, :gl[b, 0]],
                                      wt[b, 0, :wl[b, 0]])
    np.testing.assert_allclose(gs[real], ws[real], rtol=1e-4, atol=1e-6)
    return want, got, steps


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("logprob", [False, True])
def test_matches_jax(K, logprob):
    run_both(CFG, K, logprob)


def test_additive_attention_matches_jax():
    run_both(CFG.replace(mode="add"), 4, True, seed=2)


@pytest.mark.parametrize("model,emb", [("lstm", 0), ("gru", 6), ("rnn", 6)])
def test_lm_fusion_matches_jax(model, emb):
    cfg = CFG.replace(lm_weight=0.5)
    run_both(cfg, 3, True, seed=5, lm=lm_pair(cfg, model, emb))


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_gnmt_length_penalty_matches_jax(alpha):
    run_both(CFG.replace(beam_len_penalty=alpha), 4, True, seed=3)


@pytest.mark.parametrize("beta,reward", [(0.5, 0.0), (0.0, 0.2),
                                         (0.1, 0.1)])
def test_coverage_scoring_matches_jax(beta, reward):
    cfg = CFG.replace(beam_coverage_penalty=beta,
                      beam_coverage_reward=reward, beam_coverage_tau=0.4)
    run_both(cfg, 4, True, seed=5)


@pytest.mark.parametrize("margin", [0.0, 1.5])
def test_eos_margin_matches_jax(margin):
    run_both(CFG.replace(beam_eos_margin=margin), 4, True, seed=7)


def test_joint_ctc_matches_jax():
    run_both(CFG.replace(ctc=True, ctc_beam_weight=0.5), 4, True, seed=4)


def test_everything_at_once_matches_jax():
    """LM fusion, joint CTC, GNMT length penalty, both coverage terms and
    the EOS margin in one search."""
    cfg = CFG.replace(ctc=True, ctc_beam_weight=0.5, lm_weight=0.3,
                      beam_len_penalty=0.6, beam_coverage_penalty=0.1,
                      beam_coverage_reward=0.1, beam_eos_margin=2.0)
    run_both(cfg, 4, True, seed=6, lm=lm_pair(cfg))


def test_beam_above_top_expansions_matches_jax():
    """K = 70 > 64 engages the per-beam pruning; vocab 100 > 64 keeps it
    live at every step, and at step 0 only 64 of the 70 slots are real."""
    run_both(CFG.replace(vocab_size=100), 70, False, seed=21)


def _stops(res, lens, cfg):
    """Per utterance: ('bank', step) when K hypotheses ended in EOS before
    its budget, else ('budget', dec_step)."""
    tokens, lengths, scores = res
    budget = np.clip((np.asarray(lens, np.float32)
                      * np.float32(cfg.convert_rate)).astype(np.int32), 1,
                     int(cfg.convert_rate * T))
    out = []
    for b in range(len(lens)):
        real = scores[b] > jbeam.NEG / 2
        eos = [tokens[b, k, lengths[b, k] - 1] == 2
               for k in range(len(real)) if real[k]]
        if all(eos) and len(eos) == len(real) \
                and lengths[b].max() < budget[b]:
            out.append(("bank", int(lengths[b].max())))
        else:
            out.append(("budget", int(budget[b])))
    return out


@pytest.mark.parametrize("joint", [False, True])
def test_ragged_batch_freezes_finished_utterances(joint):
    """Utterances stop at different steps, some because their bank holds
    K hypotheses and some at their own step budget: each stopped row's
    carry stays frozen while the others step on, as under JAX's vmapped
    while_loop."""
    lens = (32, 29, 17, 11, 24, 6)
    cfg, lm = CFG, None
    if joint:
        cfg = CFG.replace(ctc=True, ctc_beam_weight=0.5, lm_weight=0.3)
        lm = lm_pair(cfg)
    want, _, steps = run_both(cfg, 3, True, lens=lens, lm=lm, eos_bias=-0.5)
    stops = _stops(want, lens, cfg)
    kinds = {k for k, _ in stops}
    assert kinds == {"bank", "budget"}, stops
    assert len({s for _, s in stops}) >= 3, stops
    assert steps == max(s for _, s in stops)


def test_beam1_equals_greedy_prefix():
    """K = 1 with raw-logit scoring follows the greedy argmax rollout up
    to its first EOS or <SOS> (which beam search never re-emits)."""
    rng = np.random.default_rng(3)
    params, state = jax_model(CFG, rng, 3)
    model = convert.from_jax_params(params, state, CFG, CPU)
    x = torch.from_numpy(rng.standard_normal((3, T, 8, 3)).astype(
        np.float32))
    lens = torch.tensor([32, 25, 14], dtype=torch.int32)
    max_steps = int(CFG.convert_rate * T)
    res = tbeam.beam_search(model, x, lens, CFG, max_steps, 1)
    _, y_hat = trainer.eval_forward(model, x, lens, CFG, max_steps)
    for b in range(3):
        n = int(res.lengths[b, 0])
        greedy = y_hat[b].numpy()
        limit = n
        for stop, extra in ((2, 1), (1, 0)):
            hit = np.nonzero(greedy == stop)[0]
            if len(hit) and hit[0] + extra < limit:
                limit = int(hit[0]) + extra
        assert limit > 0
        np.testing.assert_array_equal(res.tokens[b, 0, :limit].numpy(),
                                      greedy[:limit])


def test_prune_expansions_keeps_ties():
    scores = torch.tensor([[3.0, 1.0, 1.0, 1.0, 0.0],
                           [0.0, 2.0, 5.0, 2.0, 2.0]])
    got = tbeam.prune_expansions(scores, 2)
    N = tbeam.NEG
    torch.testing.assert_close(got, torch.tensor(
        [[3.0, 1.0, 1.0, 1.0, N], [N, 2.0, 5.0, 2.0, 2.0]]))
    assert tbeam.prune_expansions(scores, 5) is scores
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 100)).astype(np.float32)
    np.testing.assert_array_equal(
        tbeam.prune_expansions(torch.from_numpy(x), 64).numpy(),
        np.asarray(jbeam.prune_expansions(x, 64)))


def test_step_budget_is_computed_in_float32():
    """dec_step = int32(float32(featlen) * convert_rate), clamped to
    [1, max_steps], as JAX computes it.  At rate 0.13 float64 truncates to
    another step count at some lengths (featlen 900: 116 in float32, 117
    in float64), so those lengths tell the two apart."""
    featlen = np.arange(0, 4000, dtype=np.int32)
    for rate in (0.12, 0.13):
        cfg = CFG.replace(convert_rate=rate)
        want = np.asarray(jax.numpy.minimum(jax.numpy.maximum(
            (featlen.astype(np.float32) * rate).astype(np.int32), 1), 600))
        got = tbeam.step_budget(torch.from_numpy(featlen), cfg, 600).numpy()
        np.testing.assert_array_equal(got, want)
    f64 = np.clip((featlen * 0.13).astype(np.int64), 1, 600)
    assert (f64 != want).sum() > 0


def test_guards():
    rng = np.random.default_rng(0)
    params, state = jax_model(CFG, rng)
    model = convert.from_jax_params(params, state, CFG, CPU)
    x = torch.zeros((1, T, 8, 3))
    lens = torch.tensor([T], dtype=torch.int32)
    cfg = CFG.replace(ctc_beam_weight=0.3)
    with pytest.raises(ValueError, match="beam_logprob"):
        tbeam.beam_search(model, x, lens, cfg, 4, 2, logprob=False)
    with pytest.raises(ValueError, match="ctc_head"):
        tbeam.beam_search(model, x, lens, cfg, 4, 2, logprob=True)


def test_coverage_without_logprob_warns(caplog):
    rng = np.random.default_rng(0)
    params, state = jax_model(CFG, rng)
    model = convert.from_jax_params(params, state, CFG, CPU)
    cfg = CFG.replace(beam_coverage_reward=0.1)
    with caplog.at_level(logging.WARNING, logger="beam"):
        res = tbeam.beam_search(model, torch.zeros((1, T, 8, 3)),
                                torch.tensor([T], dtype=torch.int32), cfg,
                                4, 2, logprob=False)
    assert "--beam_logprob True" in caplog.text
    assert torch.isfinite(res.scores[:, 0]).all()
