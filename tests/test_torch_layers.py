"""Port layers (automatic_speech_recognition_torch/ops/layers.py) against
the JAX package's layers on the same NumPy inputs and weights.

Tolerance rtol 1e-5 / atol 1e-5: float32 on both sides, sums in another
order.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from automatic_speech_recognition_tpu.ops import layers as JL
from automatic_speech_recognition_torch.ops import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_dense_is_linear_with_transposed_weight(rng):
    p = JL.dense_init(jax.random.PRNGKey(0), 5, 7)
    p["b"] = rng.standard_normal(7).astype(np.float32)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    lin = nn.Linear(5, 7)
    with torch.no_grad():
        lin.weight.copy_(_t(p["w"]).T)
        lin.bias.copy_(_t(p["b"]))
    _close(lin(_t(x)), JL.dense_apply(p, x))


def test_embedding_lookup(rng):
    p = JL.embedding_init(jax.random.PRNGKey(1), 11, 6)
    ids = rng.integers(0, 11, (4, 3))
    _close(TL.embedding_lookup(_t(p["table"]), torch.from_numpy(ids)),
           JL.embedding_lookup(p, ids))


def test_rnn_cell(rng):
    p = JL.rnn_cell_init(jax.random.PRNGKey(2), 5, 8)
    p["b"] = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    h = rng.standard_normal((3, 8)).astype(np.float32)
    cell = nn.Linear(13, 8)
    with torch.no_grad():
        cell.weight.copy_(_t(p["w"]).T)
        cell.bias.copy_(_t(p["b"]))
    _close(TL.rnn_cell_apply(cell, _t(x), _t(h)), JL.rnn_cell_apply(p, x, h))


def test_birnn_runs_backward_over_the_full_padded_sequence(rng):
    D, U = 5, 6
    p = JL.birnn_init(jax.random.PRNGKey(3), D, U)
    for d in ("fw", "bw"):
        p[d]["b"] = rng.standard_normal(U).astype(np.float32)
    xs = rng.standard_normal((2, 9, D)).astype(np.float32)
    xs[1, 5:] = 0.0                                  # a padded tail
    rnn = TL.make_birnn(D, U)
    with torch.no_grad():
        for d, sfx in (("fw", ""), ("bw", "_reverse")):
            w = _t(p[d]["w"])
            getattr(rnn, f"weight_ih_l0{sfx}").copy_(w[:D].T)
            getattr(rnn, f"weight_hh_l0{sfx}").copy_(w[D:].T)
            getattr(rnn, f"bias_ih_l0{sfx}").copy_(_t(p[d]["b"]))
            getattr(rnn, f"bias_hh_l0{sfx}").zero_()
    want, _ = JL.birnn_apply(p, xs)
    _close(TL.birnn_apply(rnn, _t(xs)), want)


@pytest.mark.parametrize("T,D", [(8, 13), (7, 13), (8, 12), (7, 6), (1, 2)])
def test_conv2d_tf_same_padding(rng, T, D):
    p = JL.conv2d_init(jax.random.PRNGKey(4), 3, 4)
    x = rng.standard_normal((2, T, D, 3)).astype(np.float32)
    want = JL.conv2d_apply(p, x, stride=2)
    got = TL.conv2d_apply(_t(x), _t(p["w"]).permute(3, 2, 0, 1),
                          _t(p["b"]), stride=2)
    assert tuple(got.shape) == want.shape == (2, -(-T // 2), -(-D // 2), 4)
    _close(got, want)


def test_bn_inference_uses_the_moving_statistics(rng):
    C = 6
    params, state = JL.bn_init(C)
    params = {k: rng.standard_normal(C).astype(np.float32) for k in params}
    state = {"mean": rng.standard_normal(C).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    x = rng.standard_normal((2, 5, C)).astype(np.float32)
    want, _ = JL.bn_apply(params, state, x, is_training=False)
    bn = TL.BatchNorm(C)
    with torch.no_grad():
        bn.scale.copy_(_t(params["scale"]))
        bn.bias.copy_(_t(params["bias"]))
        bn.mean.copy_(_t(state["mean"]))
        bn.var.copy_(_t(state["var"]))
    _close(bn(_t(x)), want)


def test_length_mask():
    lens = np.array([0, 1, 4, 6], np.int32)
    _close(TL.length_mask(torch.from_numpy(lens), 5),
           JL.length_mask(lens, 5))
