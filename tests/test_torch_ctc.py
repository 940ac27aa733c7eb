"""Port CTC decoding (automatic_speech_recognition_torch/decoding/
ctc_prefix.py, decoding/ctc.py) against the JAX package's.

ctc_prefix.step runs its recursion as a Hillis-Steele doubling scan, JAX
as lax.associative_scan: the association order differs, so values agree
within float32 rounding, 1e-5 absolute plus 1e-6 relative in the log
domain (T <= 64; a log-probability near -120 has an ulp of 7.6e-6), and
entries at log-zero (<= NEG / 2) agree in being log-zero.  The JAX
package's brute-force alignment enumeration (host_reference_prefix_logp,
NumPy) is the oracle at T <= 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.decoding import ctc as jctc
from automatic_speech_recognition_tpu.decoding import ctc_prefix as jcp
from automatic_speech_recognition_torch.decoding import ctc as tctc
from automatic_speech_recognition_torch.decoding import ctc_prefix as tcp
from automatic_speech_recognition_torch.models import convert

from test_torch_las import jax_cfg, jax_model, small_cfg

ATOL, RTOL = 1e-5, 1e-6
jstep = jax.jit(jcp.step)
CPU = torch.device("cpu")


def logp(rng, T, Vp1):
    x = rng.standard_normal((T, Vp1)).astype(np.float32)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def assert_log_close(got, want):
    """Within ATOL + RTOL where finite; both <= NEG / 2 at log-zero."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    zero = want <= jcp.NEG / 2
    np.testing.assert_array_equal(got <= tcp.NEG / 2, zero)
    np.testing.assert_allclose(got[~zero], want[~zero], rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("T", [7, 16, 33, 64])
@pytest.mark.parametrize("first", [True, False])
def test_step_matches_jax(rng, T, first):
    """psi_delta, r_all and psi at odd and power-of-two T, with repeated
    last ids, no last id (-1), and a masked tail."""
    K, V = 3, 5
    x = jcp.masked_logp(jnp.asarray(logp(rng, T, V + 1)), T - 2)
    # realistic prefix states: one step from the empty prefix
    _, r1, psi1 = jstep(x, jcp.init_state(x)[None], jnp.zeros((1,)),
                        jnp.array([-1]), jnp.array(True))
    toks = np.array([0, 2, 4])
    r_prev = np.asarray(r1)[0, toks]
    psi_prev = np.asarray(psi1)[0, toks]
    if first:
        r_prev = np.broadcast_to(np.asarray(jcp.init_state(x)), (K, T, 2))
        psi_prev = np.zeros((K,), np.float32)
    last = np.array([-1, 2, 4], np.int32)
    want = jstep(x, jnp.asarray(r_prev), jnp.asarray(psi_prev),
                 jnp.asarray(last), jnp.array(first))
    got = tcp.step(torch.from_numpy(np.array(x)),
                   torch.from_numpy(np.ascontiguousarray(r_prev)),
                   torch.from_numpy(psi_prev), torch.from_numpy(last),
                   torch.tensor(first))
    for g, w in zip(got, want):
        assert_log_close(g.numpy(), w)


def test_step_takes_a_batch_axis(rng):
    """The beam calls step on (B, ...) inputs with one first_step flag per
    utterance: equal to B separate calls (up to the ulp that vectorized
    CPU loops may change with the layout)."""
    T, K, V = 9, 2, 4
    xs = np.stack([logp(rng, T, V + 1) for _ in range(3)])
    x = tcp.masked_logp(torch.from_numpy(xs), torch.tensor([9, 5, 1]))
    r0 = tcp.init_state(x)[:, None].expand(3, K, T, 2)
    last = torch.tensor([[-1, 1], [0, 3], [2, 2]])
    first = torch.tensor([True, False, True])
    batched = tcp.step(x, r0, torch.zeros(3, K), last, first)
    for b in range(3):
        one = tcp.step(x[b], r0[b], torch.zeros(K), last[b], first[b])
        for g, w in zip(batched, one):
            torch.testing.assert_close(g[b], w, rtol=1e-6, atol=0)


@pytest.fixture
def tiny(rng):
    return logp(rng, 4, 4)          # T = 4, candidates {0, 1, 2}, blank 3


def _first(x):
    x = torch.from_numpy(x)
    return tcp.step(x, tcp.init_state(x)[None], torch.zeros(1),
                    torch.tensor([-1]), True)


def test_first_token_matches_bruteforce(tiny):
    psi_delta, _, _ = _first(tiny)
    for c in range(3):
        want = jcp.host_reference_prefix_logp(tiny.astype(np.float64), [c])
        np.testing.assert_allclose(float(psi_delta[0, c]), want, rtol=1e-4)


@pytest.mark.parametrize("c1", [0, 1])
def test_second_token_matches_bruteforce(tiny, c1):
    """Including the repeat c2 == c1, which needs a blank in between."""
    _, r_all, psi_all = _first(tiny)
    psi_delta2, _, psi2 = tcp.step(
        torch.from_numpy(tiny), r_all[:, c1], psi_all[:, c1],
        torch.tensor([c1]), False)
    for c2 in range(3):
        want = jcp.host_reference_prefix_logp(tiny.astype(np.float64),
                                              [c1, c2])
        np.testing.assert_allclose(float(psi2[0, c2]), want, rtol=1e-4)
        np.testing.assert_allclose(float(psi_delta2[0, c2]),
                                   want - float(psi_all[0, c1]), rtol=1e-4)


def test_length_masking_equals_truncation(rng):
    x = logp(rng, 6, 4)
    masked = tcp.masked_logp(torch.from_numpy(x), torch.tensor(3))
    psi_m, _, _ = _first(masked.numpy())
    psi_t, _, _ = _first(x[:3].copy())
    np.testing.assert_allclose(psi_m.numpy(), psi_t.numpy(), rtol=0,
                               atol=ATOL)
    for c in range(3):
        want = jcp.host_reference_prefix_logp(x[:3].astype(np.float64), [c])
        np.testing.assert_allclose(float(psi_m[0, c]), want, rtol=1e-4)
    # log-zero stays finite: logaddexp(NEG, NEG) is NEG, not NaN
    assert torch.isfinite(tcp.init_state(masked)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_greedy_decode_matches_jax(rng, seed):
    cfg = small_cfg(ctc=True)
    params, state = jax_model(cfg, rng, seed)
    x = rng.standard_normal((3, 41, 13, 3)).astype(np.float32)
    xl = np.array([41, 30, 9], np.int32)
    want_tok, want_len = jctc.ctc_greedy_decode(params, state, x, xl, jax_cfg(cfg))
    model = convert.from_jax_params(params, state, cfg, CPU)
    got_tok, got_len = tctc.ctc_greedy_decode(
        model, torch.from_numpy(x), torch.from_numpy(xl), cfg)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_len.sum() > 0
    with pytest.raises(ValueError, match="--ctc True"):
        tctc.ctc_greedy_decode(
            convert.from_jax_params(*jax_model(small_cfg(), rng),
                                    small_cfg(), CPU),
            torch.from_numpy(x), torch.from_numpy(xl), cfg)
