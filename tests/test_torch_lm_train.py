"""The port's char-RNNLM training and sampling (automatic_speech_recognition_
torch/models/char_rnn.py: LMOptimizer, lm_train_step, lm_eval_loss,
sample_seq, BatchGenerator; the train_lm and sample_lm entry points)
against the JAX package's models/char_rnn.py and its CLIs.

JAX params come from lm_init and go to the port through
convert.from_jax_lm_params; the same NumPy ids go through both.
Tolerances:
- train steps, from converted params with the recurrent state carried:
  loss, state and parameters rtol 1e-5 / atol 2e-6.  optax takes Adam's
  bias correction 1 - 0.999^t in float32 (about 3e-5 relative at t = 1),
  torch.optim.Adam in float64, so each update of lr 2e-3 may differ by
  about 6e-8; the rest is float32 sums in another order;
- lm_eval_loss within 1e-6 (absolute and relative);
- BatchGenerator rows and greedy sample ids: equal.
Dropout draws from a torch.Generator, not JAX keys: held to its effect.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.models import char_rnn as jcr
from automatic_speech_recognition_torch import sample_lm as sample_cli
from automatic_speech_recognition_torch import train_lm as train_lm_cli
from automatic_speech_recognition_torch.decoding import beam as beam_lib
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert, las

from test_torch_las import small_cfg

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=2e-6)


def _cfgs(**kw):
    base = dict(vocab_size=10, hidden_size=12, embedding_size=6,
                num_layers=2, model="lstm", num_unrollings=5, batch_size=3)
    base.update(kw)
    return jcr.LMConfig(**base), tcr.LMConfig(**base)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]


def _to_np(state):
    return jax.tree_util.tree_map(
        lambda t: t.numpy(), state,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("model,max_grad_norm", [("lstm", 5.0),
                                                 ("lstm", 0.05),
                                                 ("gru", 5.0),
                                                 ("rnn", 0.05)])
def test_lm_train_step_matches_jax(rng, model, max_grad_norm, steps):
    jcfg, tcfg = _cfgs(model=model, max_grad_norm=max_grad_norm)
    jts = jcr.create_lm_train_state(jax.random.PRNGKey(0), jcfg)
    lm = convert.from_jax_lm_params(
        jax.tree_util.tree_map(np.asarray, jts.params), tcfg, CPU)
    tts = tcr.LMTrainState(lm, tcr.make_lm_optimizer(lm, tcfg), 0,
                           torch.Generator().manual_seed(0))
    ids = rng.integers(0, 10, (steps, 3, 6)).astype(np.int32)
    jstate, tstate = jcr.zero_state(jcfg, 3), tcr.zero_state(tcfg, 3)
    for k in range(steps):
        x, y = ids[k, :, :-1], ids[k, :, 1:]
        jts, jloss, jstate = jcr.lm_train_step(jts, x, y, jstate, jcfg)
        tloss, tstate = tcr.lm_train_step(tts, torch.from_numpy(x),
                                          torch.from_numpy(y), tstate, tcfg)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        for g, w in zip(_leaves(_to_np(tstate)), _leaves(jstate)):
            np.testing.assert_allclose(g, w, **TOL)
    assert tts.step == steps
    assert all(not s.requires_grad for s in jax.tree_util.tree_leaves(
        tstate, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = jax.tree_util.tree_map(np.asarray, jts.params)
    got = convert.to_jax_lm_params(tts.model)
    for (kw, w), (kg, g) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(want),
                   key=lambda t: jax.tree_util.keystr(t[0])),
            sorted(jax.tree_util.tree_leaves_with_path(got),
                   key=lambda t: jax.tree_util.keystr(t[0]))):
        assert jax.tree_util.keystr(kw) == jax.tree_util.keystr(kg)
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(kw),
                                   **TOL)


@pytest.mark.parametrize("model", ["lstm", "gru"])
def test_lm_eval_loss_matches_jax(rng, model):
    jcfg, tcfg = _cfgs(model=model, embedding_size=0)
    params = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(1), jcfg))
    lm = convert.from_jax_lm_params(params, tcfg, CPU)
    x = rng.integers(0, 10, (3, 7)).astype(np.int32)
    y = rng.integers(0, 10, (3, 7)).astype(np.int32)
    want, wstate = jcr.lm_eval_loss(params, x, y, jcr.zero_state(jcfg, 3),
                                    jcfg)
    got, gstate = tcr.lm_eval_loss(lm, torch.from_numpy(x),
                                   torch.from_numpy(y),
                                   tcr.zero_state(tcfg, 3), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    for g, w in zip(_leaves(_to_np(gstate)), _leaves(wstate)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch,unroll", [(2, 3), (5, 10), (1, 1)])
def test_batch_generator_rows_equal_jax(rng, batch, unroll):
    ids = rng.integers(0, 28, 157).astype(np.int32)
    jg = jcr.BatchGenerator(ids, batch, unroll)
    tg = tcr.BatchGenerator(ids, batch, unroll)
    for _ in range(40):
        np.testing.assert_array_equal(tg.next(), jg.next())


@pytest.mark.parametrize("model", ["lstm", "gru", "rnn"])
def test_sample_seq_greedy_ids_equal_jax(model):
    jcfg, tcfg = _cfgs(model=model)
    params = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(2), jcfg))
    lm = convert.from_jax_lm_params(params, tcfg, CPU)
    want = jcr.sample_seq(params, jcfg, 25, [1, 2, 3], max_prob=True)
    assert tcr.sample_seq(lm, tcfg, 25, [1, 2, 3]) == want
    # temperature sampling: reproducible from its generator, in range
    draw = lambda seed: tcr.sample_seq(
        lm, tcfg, 25, [1, 2], generator=torch.Generator().manual_seed(seed),
        temperature=2.0, max_prob=False)
    assert draw(3) == draw(3) and draw(3) != draw(4)
    assert all(0 <= i < 10 for i in draw(3))
    assert len(tcr.sample_seq(lm, tcfg, 4, [])) == 4   # random first id


def test_lm_training_reduces_ppl():
    _, cfg = _cfgs(model="lstm", num_unrollings=8, batch_size=4,
                   learning_rate=1e-2)
    # a deterministic cyclic sequence is perfectly predictable
    ids = np.tile(np.arange(10, dtype=np.int32), 40)
    gen = tcr.BatchGenerator(ids, cfg.batch_size, cfg.num_unrollings)
    ts = tcr.create_lm_train_state(cfg, 0, CPU)
    state = tcr.zero_state(cfg, cfg.batch_size)
    losses = []
    for _ in range(60):
        rows = torch.from_numpy(gen.next())
        loss, state = tcr.lm_train_step(ts, rows[:-1].T, rows[1:].T, state,
                                        cfg)
        losses.append(loss.item())
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_dropout_changes_training_and_is_identity_at_eval(rng):
    _, base = _cfgs(embedding_size=6)
    drop = base.replace(dropout=0.5, input_dropout=0.3)
    x = torch.from_numpy(rng.integers(0, 10, (3, 4)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 10, (3, 4)).astype(np.int32))
    state = tcr.zero_state(base, 3)
    losses = {}
    for name, cfg, seed in (("plain", base, 7), ("drop", drop, 7),
                            ("drop2", drop, 8)):
        ts = tcr.create_lm_train_state(cfg, 0, CPU)
        ts.generator.manual_seed(seed)
        losses[name] = tcr.lm_train_step(ts, x, y, state, cfg)[0].item()
    assert abs(losses["plain"] - losses["drop"]) > 1e-6
    assert abs(losses["drop"] - losses["drop2"]) > 1e-6
    m0 = tcr.create_lm_train_state(base, 0, CPU).model
    m1 = tcr.create_lm_train_state(drop, 0, CPU).model
    e0 = tcr.lm_eval_loss(m0, x, y, state, base)[0]
    e1 = tcr.lm_eval_loss(m1, x, y, state, drop)[0]
    assert e0.item() == e1.item()


CORPUS = ("the quick brown fox jumps over the lazy dog. " * 30
          + "she sells sea shells by the sea shore! " * 30)


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    (d / "corpus.txt").write_text(CORPUS)
    res = train_lm_cli.main([
        "--device", "cpu", "--data_file", str(d / "corpus.txt"),
        "--output_dir", str(d / "out"), "--num_epochs", "3",
        "--hidden_size", "24", "--batch_size", "4", "--num_unrollings", "8",
        "--learning_rate", "1e-2"])
    return d / "out", res


def test_train_lm_writes_a_directory_decode_reads(lm_dir):
    out, res = lm_dir
    hist = res["history"]
    assert len(hist["valid_ppl"]) == 3
    assert hist["valid_ppl"][-1] < hist["valid_ppl"][0]
    result = json.loads((out / "result.json").read_text())
    assert result["best_model"] == int(np.argmin(hist["valid_ppl"])) + 1
    assert result["latest_model"] == 3 and np.isfinite(result["test_ppl"])
    assert sorted(os.listdir(out / "lang" / "save_model")) == \
        ["1.pt", "2.pt", "3.pt"]
    assert os.listdir(out / "lang" / "best_model") == \
        [f"{result['best_model']}.pt"]
    lm, cfg, v2i, i2v = tcr.load_lm_dir(str(out))
    assert cfg.hidden_size == 24 and len(v2i) == 28 and i2v[v2i["A"]] == "A"
    # the best model's weights, and the fusion LM of a beam search
    payload = torch.load(out / "lang" / "best_model"
                         / f"{result['best_model']}.pt", weights_only=True)
    for k, v in lm.state_dict().items():
        assert torch.equal(v, payload["model"][k])
    las_cfg = small_cfg(apply_lm=True, lm_weight=0.5, beam_logprob=True)
    model = las.init(las_cfg, torch.Generator().manual_seed(0), CPU)
    feats = torch.randn(2, 24, 13, 3, generator=torch.Generator()
                        .manual_seed(1))
    featlen = torch.tensor([24, 17], dtype=torch.int32)
    fused = beam_lib.beam_search(model, feats, featlen, las_cfg, 6, 3, True,
                                 lm, cfg)
    plain = beam_lib.beam_search(model, feats, featlen, las_cfg, 6, 3, True)
    assert torch.isfinite(fused.scores[:, 0]).all()
    assert not torch.equal(fused.scores, plain.scores)


def test_train_lm_resumes_from_save_model(lm_dir, tmp_path):
    out, _ = lm_dir
    (tmp_path / "corpus.txt").write_text(CORPUS)
    res = train_lm_cli.main([
        "--device", "cpu", "--data_file", str(tmp_path / "corpus.txt"),
        "--init_dir", str(out), "--num_epochs", "1",
        "--hidden_size", "24", "--batch_size", "4", "--num_unrollings", "8",
        "--learning_rate", "1e-2"])
    assert res["latest_model"] == 4
    assert sorted(os.listdir(out / "lang" / "save_model")) == \
        ["1.pt", "2.pt", "3.pt", "4.pt"]


def test_sample_lm_matches_jax_on_the_same_weights(lm_dir, capsys):
    out, _ = lm_dir
    lm, cfg, v2i, i2v = tcr.load_lm_dir(str(out))
    jcfg = jcr.LMConfig(**json.loads(cfg.to_json()))
    params = convert.to_jax_lm_params(lm)
    text = sample_cli.main(["--device", "cpu", "--init_dir", str(out),
                            "--start_text", "THE ", "--length", "30"])
    start = [v2i[c] for c in "THE "]
    want = jcr.sample_seq(params, jcfg, 30, start)
    assert text == "THE " + "".join(i2v[i] for i in want)
    ppl = sample_cli.main(["--device", "cpu", "--init_dir", str(out),
                           "--evaluate", "--example_text", "THE SEA."])
    ids = np.asarray([v2i[c] for c in "THE SEA."], np.int32)
    loss, _ = jcr.lm_eval_loss(params, ids[None, :-1], ids[None, 1:],
                               jcr.zero_state(jcfg, 1), jcfg)
    np.testing.assert_allclose(ppl, float(jnp.exp(loss)), rtol=1e-5)
    assert "Perplexity is:" in capsys.readouterr().out
