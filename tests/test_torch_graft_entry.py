"""The port's entry points (automatic_speech_recognition_torch/
graft_entry.py) against the repository's __graft_entry__.py.

entry(): the JAX flagship greedy forward on the JAX CPU backend and the
port's on the CPU, the port's weights converted from the JAX parameters
(models/convert.py), on the same example features: the logits agree
within rtol 1e-5 / atol 1e-5, the tolerance of the greedy-forward parity
test (tests/test_torch_las.py: float32 on both sides, sums in another
order).  dryrun_multichip(4, "cpu"): four gloo ranks at dp 2 x tp 2
through the port's launcher (the train step, the raw-audio step with
speed perturbation, greedy and beam eval), then two hosts of two ranks
started through the multi-host environment, whose loss equals one
process's on the whole batch within rtol 1e-4 / atol 1e-5
(graft_entry.LOSS_RTOL, the two-rank tolerance)."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from automatic_speech_recognition_torch import graft_entry

TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_flagship_cfg_is_the_jax_one():
    want, got = jentry._flagship_cfg(), graft_entry.flagship_cfg()
    # every field the JAX package has; the port's own rnn_cell is the
    # reference's tanh cell
    shared = [f.name for f in dataclasses.fields(want)]
    assert {n: getattr(got, n) for n in shared} \
        == {n: getattr(want, n) for n in shared}
    assert [f.name for f in dataclasses.fields(got)
            if f.name not in shared] == ["rnn_cell"]
    assert got.rnn_cell == "rnn"
    assert graft_entry.dryrun_cfg(2).loc_kernel_size == 201


def test_entry_matches_the_jax_entry():
    jfn, (params, bn_state, audio, audiolen) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(params, bn_state, audio, audiolen))
    fn, args = graft_entry.entry("cpu", _numpy(params), _numpy(bn_state))
    model, t_audio, t_len = args
    np.testing.assert_array_equal(t_audio.numpy(), np.asarray(audio))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(audiolen))
    assert not model.training
    got = fn(*args)
    assert got.shape == want.shape == (4, 40, 30)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_entry_with_seeded_weights_and_no_gpu():
    """Without a pytree the weights come from a generator seeded 0: two
    calls give the same logits.  A GPU request without one raises, never
    answered with the CPU."""
    fn, args = graft_entry.entry("cpu")
    a, b = fn(*args), fn(*graft_entry.entry("cpu")[1])
    assert a.shape == (4, 40, 30) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graft_entry.entry("cuda")


@pytest.fixture(scope="module")
def dryrun():
    """dryrun_multichip(4) on gloo CPU ranks: (the rank reports, the
    lines it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = graft_entry.dryrun_multichip(4, "cpu")
    return got, out.getvalue()


def test_dryrun_prints_the_jax_dry_runs_lines(dryrun):
    _, out = dryrun
    for line in ("dryrun_multichip ok: n=4 mesh=(2x2) loss=",
                 "dryrun_multichip audio-path ok: loss=",
                 "dryrun_multichip sharded eval ok: y_hat (4, 8)",
                 "dryrun_multichip sharded beam ok: tokens (4, 4, 6)",
                 "dryrun_multichip multiprocess ok: 2 hosts x 2 devices, "
                 "mesh=(2x2)"):
        assert line in out, out


def test_dryrun_ranks_agree_on_one_grid(dryrun):
    got, _ = dryrun
    ranks = got["one host"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert {(r["dp"], r["tp"], r["world"]) for r in ranks} == {(2, 2, 4)}
    for k in ("loss", "audio_loss"):
        assert len({r[k] for r in ranks}) == 1
        assert np.isfinite(ranks[0][k])
    assert all(r["y_hat"] == [4, 8] and r["beam_tokens"] == [4, 4, 6]
               and r["beam_finite"] for r in ranks)
    # the CPU takes the plain frontend: no kernel launch
    assert {r["launches"] for r in ranks} == {0}


def test_dryrun_two_hosts_split_the_batch_and_match_one_process(dryrun):
    got, _ = dryrun
    ranks = got["two hosts"]
    assert [(r["rank"], r["host"]) for r in ranks] == [
        (0, 0), (1, 0), (2, 1), (3, 1)]
    want = graft_entry.one_process_loss(2, "cpu")
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want,
                                   rtol=graft_entry.LOSS_RTOL,
                                   atol=graft_entry.LOSS_ATOL)
    assert got["one host"][0]["loss"] == ranks[0]["loss"]
