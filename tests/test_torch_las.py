"""Port LAS inference (automatic_speech_recognition_torch/models/las.py,
models/convert.py, training/trainer.py) against the JAX package.

JAX params come from las.las_init and are carried over by
models/convert.from_jax_params; the same NumPy features go through both.
Tolerance rtol 1e-5 / atol 1e-5: float32 on both sides, sums in another
order.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.config import Config as JConfig
from automatic_speech_recognition_tpu.models import las as jlas
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.training import trainer as ttrainer

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def small_cfg(**kw):
    base = dict(unit="char", vocab_size=30, feat_dim=13, enc_type="cnn",
                enc_units=32, num_enc_channels=4, num_enc_layers=2,
                dec_units=32, num_dec_layers=2, embedding_size=16,
                attention_size=16, mode="loc", dropout_rate=0.0,
                scheduled_sampling=False, convert_rate=0.12)
    base.update(kw)
    return Config(**base)


def jax_cfg(cfg):
    """The JAX package's Config with the fields of the port's `cfg`: each
    package runs on its own Config (the port's own fields, such as
    rnn_cell, left out)."""
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)
                      if f.name in JConfig.__dataclass_fields__})


def jax_model(cfg, rng, seed=0):
    """las_init params (numpy) with non-trivial biases and BN state."""
    params, state = jlas.las_init(jax.random.PRNGKey(seed), jax_cfg(cfg))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, state = to_np(params), to_np(state)

    def jitter(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                jitter(v)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k in ("b", "bias", "scale", "conv_b", "mean"):
                tree[k] = (v + 0.1 * rng.standard_normal(v.shape)
                           ).astype(np.float32)
    jitter(params)
    jitter(state)
    return params, state


def feats(rng, B=2, T=41):
    x = rng.standard_normal((B, T, 13, 3)).astype(np.float32)
    return x, np.array([T, T // 2 + 1][:B], np.int32)


@pytest.mark.parametrize("apply_bn", [False, True])
def test_listener_matches_jax(rng, apply_bn):
    cfg = small_cfg(apply_bn=apply_bn)
    params, state = jax_model(cfg, rng)
    x, xl = feats(rng)
    want, want_len, _ = jlas.listener_apply(
        params["listener"], state["listener"], x, xl, jax_cfg(cfg), is_training=False)
    model = convert.from_jax_params(params, state, cfg, CPU)
    with torch.no_grad():
        got, got_len = model.listener(torch.from_numpy(x),
                                      torch.from_numpy(xl))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_step_matches_jax(rng):
    cfg = small_cfg()
    params, state = jax_model(cfg, rng)
    sp = params["speller"]
    B, T = 2, 11
    enc = rng.standard_normal((B, T, 32)).astype(np.float32)
    enc_len = np.array([T, 4], np.int32)
    states = rng.standard_normal((2, B, 32)).astype(np.float32)
    emb = rng.standard_normal((B, 16)).astype(np.float32)
    align = rng.dirichlet(np.ones(T), B).astype(np.float32)
    want = jlas.decode_step(sp, jax_cfg(cfg), enc, enc_len, states, emb, align)
    model = convert.from_jax_params(params, state, cfg, CPU)
    with torch.no_grad():
        got = tlas.decode_step(model.speller, *map(torch.from_numpy, (
            enc, enc_len, states, emb, align)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("mode", ["add", "loc"])
def test_greedy_forward_matches_jax(rng, mode):
    cfg = small_cfg(mode=mode)
    params, state = jax_model(cfg, rng)
    x, xl = feats(rng)
    logits, _, alphas, enc_len, _ = jlas.las_forward(
        params, state, x, xl, jax_cfg(cfg), dec_steps=6, is_training=False)
    model = convert.from_jax_params(params, state, cfg, CPU)
    with torch.no_grad():
        got_logits, got_alphas, got_len = model(torch.from_numpy(x),
                                                torch.from_numpy(xl), 6)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(enc_len))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(got_alphas.numpy(), np.asarray(alphas), **TOL)


@pytest.mark.parametrize("margin", [-1.0, 0.5])
def test_eval_forward_matches_jax(rng, margin):
    cfg = small_cfg(greedy_eos_margin=margin)
    params, state = jax_model(cfg, rng)
    x, xl = feats(rng)
    logits, y_hat = jtrainer.eval_forward(params, state, x, xl, jax_cfg(cfg), 8)
    model = convert.from_jax_params(params, state, cfg, CPU)
    got_logits, got_y = ttrainer.eval_forward(
        model, torch.from_numpy(x), torch.from_numpy(xl), cfg, 8)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(y_hat))


def test_converter_rejects_missing_extra_and_misshapen_keys(rng):
    cfg = small_cfg()
    params, state = jax_model(cfg, rng)
    convert.from_jax_params(params, state, cfg, CPU)          # accepted
    bad = jax.tree_util.tree_map(lambda a: a, params)
    del bad["speller"]["out"]["b"]
    with pytest.raises(KeyError, match="speller/out/b"):
        convert.from_jax_params(bad, state, cfg, CPU)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["speller"]["extra"] = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="speller/extra/w"):
        convert.from_jax_params(bad, state, cfg, CPU)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["listener"]["conv1"]["w"] = np.zeros((3, 3, 4, 5), np.float32)
    with pytest.raises(ValueError, match="conv1/w"):
        convert.from_jax_params(bad, state, cfg, CPU)


def test_init_follows_the_jax_distributions():
    cfg = small_cfg()
    a = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    b = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    c = tlas.init(cfg, torch.Generator().manual_seed(1), CPU)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["speller.out.weight"], sc["speller.out.weight"])
    att = a.speller.attention
    limit = (6.0 / (201 + 201 * 10)) ** 0.5
    assert att.conv_w.abs().max() <= limit and att.conv_b.eq(0).all()
    assert att.u.abs().max() <= 1.0
    assert a.speller.embedding.weight.abs().max() <= 1.0
    assert a.listener.conv0.bias.eq(0.01).all()
    assert a.listener.conv0.weight.std() < 0.02
    rnn = a.listener.layers[0].birnn
    lim = (6.0 / (rnn.input_size + 2 * rnn.hidden_size)) ** 0.5
    assert rnn.weight_ih_l0.abs().max() <= lim
    assert rnn.weight_ih_l0.abs().max() > 0.9 * lim
    assert rnn.bias_hh_l0.eq(0).all() and rnn.bias_ih_l0.eq(0).all()
    bn = a.listener.layers[0].bn_main
    assert bn.scale.eq(1).all() and bn.var.eq(1).all() and bn.mean.eq(0).all()
    # same parameter set and shapes as the JAX pytree: the converter
    # accepts las_init's output for this config
    params, state = jlas.las_init(jax.random.PRNGKey(0), jax_cfg(cfg))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    convert.from_jax_params(to_np(params), to_np(state), cfg, CPU)

