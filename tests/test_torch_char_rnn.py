"""Port char-RNN LM (automatic_speech_recognition_torch/models/char_rnn.py,
ops/layers.py LM cells, models/convert.py LM converters) against the JAX
package's models/char_rnn.py.

JAX params come from lm_init and are carried over by
convert.from_jax_lm_params; the same NumPy ids go through both.
Tolerance rtol 1e-5 / atol 1e-6: float32 on both sides, sums in another
order.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.models import char_rnn as jcr
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")
CELLS = [(m, e) for m in ("rnn", "lstm", "gru") for e in (0, 6)]


def make_cfg(cls, **kw):
    base = dict(vocab_size=10, hidden_size=12, embedding_size=6,
                num_layers=2, model="lstm")
    base.update(kw)
    return cls(**base)


def jax_lm(cfg_kw, rng, seed=0):
    """lm_init params (numpy) with non-zero biases, and both configs."""
    jcfg, tcfg = make_cfg(jcr.LMConfig, **cfg_kw), make_cfg(tcr.LMConfig,
                                                            **cfg_kw)
    params = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(seed), jcfg))
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            for k in leaf:
                if k.startswith("b"):
                    leaf[k] = (leaf[k] + 0.1 * rng.standard_normal(
                        leaf[k].shape)).astype(np.float32)
    return params, jcfg, tcfg


def _state_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, state))]


@pytest.mark.parametrize("model,emb", CELLS)
def test_lm_step_matches_jax(rng, model, emb):
    params, jcfg, tcfg = jax_lm(dict(model=model, embedding_size=emb), rng)
    lm = convert.from_jax_lm_params(params, tcfg, CPU)
    ids = np.array([-1, 0, 3, 9, -2], np.int32)      # fusion's shifted ids
    state = jcr.zero_state(jcfg, 5)
    state = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), state)
    want, want_state = jcr.lm_step(params, jcfg, ids, state)
    tstate = jax.tree_util.tree_map(lambda s: torch.from_numpy(np.asarray(s)),
                                    state)
    with torch.no_grad():
        got, got_state = tcr.lm_step(lm, tcfg, torch.from_numpy(ids), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(_state_leaves(got_state), _state_leaves(want_state)):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("model,emb", CELLS)
def test_lm_apply_and_loss_match_jax(rng, model, emb):
    params, jcfg, tcfg = jax_lm(dict(model=model, embedding_size=emb), rng)
    lm = convert.from_jax_lm_params(params, tcfg, CPU)
    inputs = rng.integers(0, 10, (3, 7)).astype(np.int32)
    targets = rng.integers(0, 10, (3, 7)).astype(np.int32)
    want, want_state = jcr.lm_apply(params, jcfg, inputs,
                                    jcr.zero_state(jcfg, 3))
    want_loss, _ = jcr.lm_loss(params, jcfg, inputs, targets,
                               jcr.zero_state(jcfg, 3))
    with torch.no_grad():
        got, got_state = tcr.lm_apply(lm, tcfg, torch.from_numpy(inputs),
                                      tcr.zero_state(tcfg, 3))
        got_loss, _ = tcr.lm_loss(lm, tcfg, torch.from_numpy(inputs),
                                  torch.from_numpy(targets),
                                  tcr.zero_state(tcfg, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(_state_leaves(got_state), _state_leaves(want_state)):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("emb", [0, 6])
def test_negative_id_embeds_zero(emb):
    cfg = make_cfg(tcr.LMConfig, embedding_size=emb)
    lm = tcr.init(cfg, torch.Generator().manual_seed(0), CPU)
    x = tcr._embed(lm, cfg, torch.tensor([-1, -2, 0, 4]))
    assert x.shape == (4, cfg.input_size)
    assert torch.equal(x[:2], torch.zeros(2, cfg.input_size))
    assert x[2:].abs().sum(-1).gt(0).all()


def test_train_time_dropout_is_explicit():
    """Dropout only with is_training and a generator, as the LAS port."""
    cfg = make_cfg(tcr.LMConfig, dropout=0.5, input_dropout=0.3)
    lm = tcr.init(cfg, torch.Generator().manual_seed(0), CPU)
    ids = torch.tensor([1, 2, 3])
    run = lambda **kw: tcr.lm_step(lm, cfg, ids, tcr.zero_state(cfg, 3),
                                   **kw)[0]
    with torch.no_grad():
        plain = run()
        assert torch.equal(run(is_training=True), plain)
        dropped = run(is_training=True,
                      generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(dropped, plain)


@pytest.mark.parametrize("model,emb", CELLS)
def test_converter_round_trip(rng, model, emb):
    params, _, tcfg = jax_lm(dict(model=model, embedding_size=emb), rng)
    back = convert.to_jax_lm_params(convert.from_jax_lm_params(params, tcfg,
                                                               CPU))
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(params), flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    bad = dict(params)
    del bad["softmax_b"]
    with pytest.raises(KeyError, match="softmax_b"):
        convert.from_jax_lm_params(bad, tcfg, CPU)


def test_init_follows_lm_init():
    cfg = make_cfg(tcr.LMConfig, model="gru", embedding_size=6)
    a = tcr.init(cfg, torch.Generator().manual_seed(0), CPU)
    b = tcr.init(cfg, torch.Generator().manual_seed(0), CPU)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    cell = a.cells[0]
    assert cell.gates.bias.eq(1.0).all() and cell.candidate.bias.eq(0).all()
    lim = (6.0 / (cfg.input_size + cfg.hidden_size + 2 * cfg.hidden_size)
           ) ** 0.5
    assert cell.gates.weight.abs().max() <= lim
    assert a.softmax.bias.eq(0).all()
    # the parameter set and shapes of lm_init's tree
    jparams = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(0),
                                make_cfg(jcr.LMConfig, model="gru")))
    convert.from_jax_lm_params(jparams, cfg, CPU)


def test_lm_dir_round_trip(tmp_path, rng):
    """save_lm_dir writes sample_lm.load_lm's layout; load_lm_dir reads
    the best model back, bit for bit."""
    cfg = tcr.LMConfig(vocab_size=28, hidden_size=16, num_layers=2,
                       model="lstm")
    lm = tcr.init(cfg, torch.Generator().manual_seed(3), CPU)
    d = str(tmp_path / "lm")
    tcr.save_lm_dir(d, lm, cfg, epoch=4)
    result = json.load(open(os.path.join(d, "result.json")))
    assert result["best_model"] == 4
    assert tcr.LMConfig.from_json(json.dumps(result["params"])) == cfg
    assert os.path.exists(os.path.join(d, "lang", "best_model", "4.pt"))
    got, got_cfg, v2i, i2v = tcr.load_lm_dir(d)
    assert got_cfg == cfg and len(v2i) == 28 and i2v[v2i["A"]] == "A"
    for x, y in zip(lm.state_dict().values(), got.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="28-token"):
        tcr.save_lm_dir(str(tmp_path / "bad"), lm, cfg.replace(vocab_size=10))
    with pytest.raises(FileNotFoundError):
        os.remove(os.path.join(d, "lang", "best_model", "4.pt"))
        tcr.load_lm_dir(d)
