"""Int8 decoder weights on the port (automatic_speech_recognition_torch/
ops/quant.py and its dispatch in ops/layers.py) against the JAX package's
ops/quant.py: each test of tests/test_quantize.py, on the port and, where
both compute the same function, against JAX on the same weights.

Tolerances: the quantizer is exact (q bit-equal, scale equal: the same
float32 division and round-half-to-even on both sides); quantized layers,
logits and beam scores agree with JAX at rtol 1e-5 / atol 1e-5 (float32
sums in another order), beam scores at rtol 1e-4.  Against float weights
the limits are tests/test_quantize.py's: 2e-2 relative for a matmul, 5e-2
absolute after tanh, greedy tokens equal on > 97 % of steps.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from automatic_speech_recognition_tpu.decoding import beam as jbeam
from automatic_speech_recognition_tpu.models import char_rnn as jcr
from automatic_speech_recognition_tpu.models import las as jlas
from automatic_speech_recognition_tpu.ops import layers as JL
from automatic_speech_recognition_tpu.ops import quant as jquant
from automatic_speech_recognition_torch import decode as decode_cli
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.config import Config, parse_args
from automatic_speech_recognition_torch.data import shards
from automatic_speech_recognition_torch.decoding import beam as tbeam
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.ops import layers as TL
from automatic_speech_recognition_torch.ops import quant
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_torch_las import jax_cfg, jax_model, small_cfg

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _linear(p, w="w", b="b"):
    """nn.Linear holding a JAX dense / cell dict's (in, out) kernel."""
    m = nn.Linear(*p[w].shape)
    with torch.no_grad():
        m.weight.copy_(_t(p[w]).T)
        m.bias.copy_(_t(p[b]))
    return m


def test_quantize_matrix_matches_jax_and_bounds_the_error():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                                   # an all-zero channel
    want = jquant.quantize_matrix(w)
    got = quant.quantize_matrix(_t(w).T)
    assert got["q"].dtype == torch.int8 and got["scale"].shape == (256,)
    np.testing.assert_array_equal(got["q"].T.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert got["scale"][7] == 1.0 and not got["q"][7].any()
    deq = got["q"].float() * got["scale"][:, None]
    # symmetric per-channel int8: at most half a step per entry
    err = (deq - _t(w).T).abs()
    assert (err <= got["scale"][:, None] / 2 + 1e-8).all()


def test_dequant_matmul_matches_jax_and_float():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((640, 320)) * 0.04).astype(np.float32)
    x = rng.standard_normal((8, 640)).astype(np.float32)
    qd = quant.quantize_matrix(_t(w).T)
    got = quant.dequant_matmul(_t(x), qd["q"], qd["scale"])
    jq = jquant.quantize_matrix(w)
    want = jquant.dequant_matmul(x, jq["q"], jq["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = _t(x) @ _t(w)
    rel = float((got - ref).norm() / ref.norm())
    assert rel < 2e-2, rel


def test_layer_dispatch_quantized_vs_jax_and_float():
    rng = np.random.default_rng(2)
    p = jax.tree_util.tree_map(np.asarray,
                               JL.rnn_cell_init(jax.random.PRNGKey(0), 48, 32))
    p["b"] = (rng.standard_normal(32) * 0.1).astype(np.float32)
    x = rng.standard_normal((4, 48)).astype(np.float32)
    h = (rng.standard_normal((4, 32)) * 0.1).astype(np.float32)
    cell = _linear(p)
    qcell = quant.QuantLinear(cell)
    with torch.no_grad():
        got = TL.rnn_cell_apply(qcell, _t(x), _t(h))
        ref = TL.rnn_cell_apply(cell, _t(x), _t(h))
    want = JL.rnn_cell_apply(jquant.quantize_dense(p), x, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float((got - ref).abs().max()) < 5e-2       # tanh-squashed
    d = jax.tree_util.tree_map(np.asarray,
                               JL.dense_init(jax.random.PRNGKey(1), 32, 16))
    xd = rng.standard_normal((4, 32)).astype(np.float32)
    dense = _linear(d)
    with torch.no_grad():
        out = quant.QuantLinear(dense)(_t(xd))
        ref_d = dense(_t(xd))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JL.dense_apply(jquant.quantize_dense(d), xd)),
        **TOL)
    assert float((out - ref_d).norm() / ref_d.norm()) < 2e-2


LM_KW = dict(model="lstm", hidden_size=16, num_layers=2, vocab_size=28,
             embedding_size=8)


def test_lstm_cell_quantized_and_lm_fusion_matches_jax(rng):
    """The lstm dispatch (fusion LM) against JAX's quantized cell, then a
    beam search with a quantized speller and a quantized fusion LM: rank
    0 equal to JAX's on the same int8 trees."""
    p = jax.tree_util.tree_map(np.asarray,
                               JL.lstm_cell_init(jax.random.PRNGKey(0), 24,
                                                 16))
    x = rng.standard_normal((4, 24)).astype(np.float32)
    st = (np.zeros((4, 16), np.float32), np.zeros((4, 16), np.float32))
    with torch.no_grad():
        got, _ = TL.lstm_cell_apply(quant.QuantLinear(_linear(p)), _t(x),
                                    tuple(map(_t, st)))
        ref, _ = TL.lstm_cell_apply(_linear(p), _t(x), tuple(map(_t, st)))
    want, _ = JL.lstm_cell_apply(jquant.quantize_dense(p), x, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float((got - ref).abs().max()) < 5e-2

    lm_params = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(1), jcr.LMConfig(**LM_KW)))
    lm_cfg = tcr.LMConfig(**LM_KW)
    lm = convert.from_jax_lm_params(lm_params, lm_cfg, CPU)
    lm_q = quant.quantize_lm(lm, lm_cfg)
    assert isinstance(lm_q.cells[0], quant.QuantLinear)
    assert isinstance(lm.cells[0], nn.Linear)          # a copy: lm untouched
    assert lm_q.softmax.weight.dtype == torch.float32  # logits stay float

    cfg = small_cfg(mode="add", apply_lm=True, lm_weight=0.2,
                    beam_logprob=True)
    params, state = jax_model(cfg, rng)
    audio = rng.standard_normal((2, 32, 13, 3)).astype(np.float32)
    lens = np.array([32, 21], np.int32)
    model = quant.quantize_model(
        convert.from_jax_params(params, state, cfg, CPU), cfg.vocab_size)
    got = tbeam.beam_search(model, _t(audio), _t(lens), cfg, 6, 3, True,
                            lm_q, lm_cfg)
    want = jbeam.beam_search(
        jquant.quantize_model_params(params, cfg.vocab_size), state, audio,
        lens, jax_cfg(cfg), max_steps=6, beam_size=3, logprob=True,
        lm_params=jquant.quantize_lm(lm_params, jcr.LMConfig(**LM_KW)),
        lm_cfg=jcr.LMConfig(**LM_KW))
    assert torch.isfinite(got.scores).all()
    for b in range(2):
        n = int(want.lengths[b, 0])
        assert int(got.lengths[b, 0]) == n
        np.testing.assert_array_equal(got.tokens[b, 0, :n].numpy(),
                                      np.asarray(want.tokens)[b, 0, :n])
    np.testing.assert_allclose(got.scores[:, 0].numpy(),
                               np.asarray(want.scores)[:, 0], rtol=1e-4)


def test_quantize_lm_softmax_and_gru_stay_float():
    cfg = tcr.LMConfig(model="gru", hidden_size=12, num_layers=1,
                       vocab_size=28, embedding_size=6)
    lm = tcr.init(cfg, torch.Generator().manual_seed(0), CPU)
    assert quant.quantize_lm(lm, cfg) is lm                 # gru: identity


@pytest.mark.parametrize("vocab", [30, 512])
def test_quantize_speller_selects_what_jax_selects(rng, tmp_path, vocab):
    """The cells always; `out` only from a vocabulary of 512 on; attention
    and the CTC head stay float; the bytes shrink.  The same matrices as
    JAX's quantize_speller, with the same q."""
    cfg = small_cfg(vocab_size=vocab, ctc=True)
    params, state = jax_model(cfg, rng)
    model = convert.from_jax_params(params, state, cfg, CPU)
    qm = quant.maybe_quantize(model, cfg.replace(quantize_decoder="int8"))
    jq = jquant.quantize_speller(params["speller"], vocab)
    sp = qm.speller
    port_q = {f"cell_{i}" for i, c in enumerate(sp.cells)
              if isinstance(c, quant.QuantLinear)}
    if isinstance(sp.out, quant.QuantLinear):
        port_q.add("out")
    assert port_q == {k for k, v in jq.items()
                      if isinstance(v, dict) and "w_q" in v}
    assert port_q == ({"cell_0", "cell_1"} | ({"out"} if vocab >= 512
                                              else set()))
    for name in port_q:
        m = sp.out if name == "out" else sp.cells[int(name[-1])]
        np.testing.assert_array_equal(m.q.T.numpy(),
                                      np.asarray(jq[name]["w_q"]))
    assert isinstance(sp.ctc_head, nn.Linear)
    assert isinstance(sp.attention.w_s, nn.Linear)
    assert quant.size_bytes(qm.speller) < quant.size_bytes(model.speller)
    assert isinstance(model.speller.cells[0], nn.Linear)    # model untouched
    # a quantized model is inference-only: it is never checkpointed
    with pytest.raises(ValueError, match="int8"):
        CheckpointManager(str(tmp_path)).save_weights(1, qm)
    assert not os.listdir(tmp_path)


def test_maybe_quantize_validates_mode():
    cfg = small_cfg(quantize_decoder="int4")
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="int4"):
        quant.maybe_quantize(model, cfg)
    assert quant.maybe_quantize(model, cfg.replace(
        quantize_decoder="none")) is model


def test_greedy_decode_agreement_trained_model():
    """Train a tiny LAS 30 steps, then greedy-decode with float vs int8
    speller weights: the argmax streams agree on > 97 % of steps, and the
    int8 logits equal JAX's on the same quantized weights."""
    cfg = Config(vocab_size=12, enc_units=24, num_enc_layers=1,
                 num_enc_channels=4, dec_units=24, num_dec_layers=2,
                 embedding_size=12, attention_size=12, feat_dim=8,
                 mode="loc", enc_type="cnn", lr=1e-2,
                 scheduled_sampling=False)
    rng = np.random.default_rng(3)
    B, T, V = 8, 64, 12
    audio = _t(rng.standard_normal((B, T, 8, 3)).astype(np.float32))
    audiolen = torch.full((B,), T, dtype=torch.int32)
    ys = _t(rng.integers(3, V, size=(B, 6)).astype(np.int32))
    batch = (audio, audiolen, ys, torch.full((B,), 6, dtype=torch.int32))
    ts = trainer.create_train_state(cfg, CPU)
    for _ in range(30):
        trainer.train_step(ts, batch, cfg)
    ts.model.eval()
    lf, ids_f = trainer.eval_forward(ts.model, audio, audiolen, cfg, 8)
    qm = quant.quantize_model(ts.model, cfg.vocab_size)
    lq, ids_q = trainer.eval_forward(qm, audio, audiolen, cfg, 8)
    agree = (ids_f == ids_q).float().mean().item()
    assert agree > 0.97, agree
    params, bn = convert.to_jax_params(ts.model)
    want, _, _, _, _ = jlas.las_forward(
        jquant.quantize_model_params(params, cfg.vocab_size), bn,
        audio.numpy(), audiolen.numpy(), jax_cfg(cfg), 8, is_training=False)
    np.testing.assert_allclose(lq.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


FLAGS = ["--unit", "char", "--feat_dim", "8", "--enc_units", "16",
         "--num_enc_channels", "4", "--num_enc_layers", "1",
         "--dec_units", "16", "--num_dec_layers", "2",
         "--embedding_size", "8", "--attention_size", "8",
         "--mode", "add", "--dropout_rate", "0.0",
         "--scheduled_sampling", "False"]


def test_decode_test_cli_and_api_with_quantization(tmp_path, rng, capsys):
    """decode --quantize_decoder int8 (beam) over feature dumps, test
    --quantize_decoder int8 (greedy) over a feature shard, and
    Recognizer.from_checkpoint with the flag all run on a port checkpoint
    (float on disk)."""
    d = str(tmp_path)
    cfg = parse_args(FLAGS).replace(vocab_size=30)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    CheckpointManager(f"{d}/model").save_weights(1, model)
    tok = CharEncoder()
    feats = np.empty(3, object)
    toks = np.empty(3, object)
    for i in range(3):
        feats[i] = rng.standard_normal(
            (int(rng.integers(30, 50)), 8, 3)).astype(np.float32)
        toks[i] = np.asarray(tok.encode("HELLO", with_eos=True), np.int32)
    np.save(f"{d}/dev-feats.npy", feats, allow_pickle=True)
    np.save(f"{d}/dev-chars.npy", toks, allow_pickle=True)
    shards.write_shard(f"{d}/dev-0.arsh", list(feats), list(toks))

    wer = decode_cli.main(["--device", "cpu"] + FLAGS + [
        "--feat_dir", d, "--save_dir", f"{d}/model", "--log_dir", f"{d}/log",
        "--split", "dev", "--beam_size", "2", "--convert_rate", "0.3",
        "--decode_batch", "3", "--decode_pad_quantum", "32",
        "--quantize_decoder", "int8"])
    assert np.isfinite(wer)

    res = test_cli.main(["--device", "cpu"] + FLAGS + [
        "--shard_dir", d, "--split", "dev", "--save_dir", f"{d}/model",
        "--log_dir", f"{d}/log_test", "--convert_rate", "0.3",
        "--bucket_boundaries_eval", "64", "--bucket_batch_sizes", "4",
        "--quantize_decoder", "int8"])
    assert res.utterances == 3 and res.skipped == 0
    assert f"WER: {res.wer:.4f}" in capsys.readouterr().out

    rec = Recognizer.from_checkpoint(
        f"{d}/model", cfg.replace(convert_rate=0.05, quantize_decoder="int8"),
        device="cpu")
    assert isinstance(rec.model.speller.cells[0], quant.QuantLinear)
    assert rec.model.speller.cells[0].q.dtype == torch.int8
    sig = (rng.standard_normal(12000) * 0.1).astype(np.float32)
    out = rec.transcribe_signals([sig])
    assert len(out) == 1 and isinstance(out[0], str)


def test_cli_flag_roundtrip():
    cfg = parse_args(["--quantize_decoder", "int8"])
    assert cfg.quantize_decoder == "int8"
    assert parse_args([]).quantize_decoder == "none"
