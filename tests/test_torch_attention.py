"""Port attention (automatic_speech_recognition_torch/ops/attention.py)
against the JAX package's attention on the same NumPy inputs and weights.

Tolerance rtol 1e-5 / atol 1e-5: float32 on both sides; the location
feature is F.conv1d in the port and a Toeplitz matmul in JAX (same math,
sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.ops import attention as JA
from automatic_speech_recognition_torch.ops import attention as TA

TOL = dict(rtol=1e-5, atol=1e-5)
H, S, A, K, C = 12, 10, 8, 201, 10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _port(p, mode):
    m = TA.Attention(mode, H, S, A, K, C)
    with torch.no_grad():
        for name in ("w_h", "w_s") + (("w_f",) if mode == "loc" else ()):
            getattr(m, name).weight.copy_(_t(p[name]["w"]).T)
        m.u.copy_(_t(p["u"]))
        if mode == "loc":
            m.conv_w.copy_(_t(p["conv_w"]).permute(2, 1, 0))
            m.conv_b.copy_(_t(p["conv_b"]))
    return m


def _inputs(rng, T):
    hidden = rng.standard_normal((3, T, H)).astype(np.float32)
    state = rng.standard_normal((3, S)).astype(np.float32)
    align = rng.dirichlet(np.ones(T), 3).astype(np.float32)
    seqlen = np.array([T, T // 2, 0], np.int32)       # last row all-masked
    return hidden, state, align, seqlen


def test_masked_attend_all_masked_row_is_uniform(rng):
    hidden, _, _, seqlen = _inputs(rng, 7)
    energy = rng.standard_normal((3, 7)).astype(np.float32)
    cj, aj = JA.masked_attend(hidden, energy, seqlen)
    ct, at = TA.masked_attend(_t(hidden), _t(energy),
                              torch.from_numpy(seqlen))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **TOL)
    assert torch.isfinite(at).all()
    np.testing.assert_allclose(at[2].numpy(), np.full(7, 1 / 7), **TOL)


@pytest.mark.parametrize("T", [37, 250])
@pytest.mark.parametrize("mode", ["add", "loc"])
def test_attention_matches_jax(rng, mode, T):
    p = JA.attention_init(jax.random.PRNGKey(0), mode, H, S, A, K, C)
    p = jax.tree_util.tree_map(np.asarray, p)
    if mode == "loc":
        p["conv_b"] = rng.standard_normal(C).astype(np.float32)
    hidden, state, align, seqlen = _inputs(rng, T)
    cj, aj = JA.attention_apply(p, mode, hidden, state, align, seqlen)
    m = _port(p, mode)
    h_proj = TA.precompute_hidden(m, _t(hidden))
    ct, at = m(_t(hidden), _t(state), _t(align), torch.from_numpy(seqlen),
               h_proj)
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(at.detach().numpy(), np.asarray(aj), **TOL)


def test_location_features_match_the_toeplitz_form(rng):
    p = JA.location_init(jax.random.PRNGKey(1), H, S, A, K, C)
    p = jax.tree_util.tree_map(np.asarray, p)
    align = rng.standard_normal((2, 60)).astype(np.float32)
    M = np.asarray(JA.precompute_location(p, 60))
    want = np.einsum("bt,tsc->bsc", align, M) + p["conv_b"]
    got = TA.location_features(_port(p, "loc"), _t(align))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
