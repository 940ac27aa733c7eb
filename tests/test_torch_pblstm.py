"""The port's pyramidal BiRNN listener (models/las.PBLSTMListener, its
converter in models/convert.py) against the JAX package's
_pblstm_listener, on JAX params carried over by convert.from_jax_params
and the same NumPy inputs.

Shapes: odd and even T (the odd-T pad lands on the padded tail at every
stage) with ragged lengths; 2 pyramid stages (time/4), enc_units 16, so
the listener, the attention keys and the CTC head are 32 wide.
Tolerances as tests/test_torch_las.py and test_torch_train.py, float32 on
both sides with sums in another order: forward rtol 1e-5 / atol 1e-5;
train steps' loss and gradient norm rtol 1e-4, parameters rtol 1e-4 /
atol 1e-5 (no BN: every bias gets a real gradient); beam scores rtol
1e-4 with rank-0 tokens equal.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.decoding import beam as jbeam
from automatic_speech_recognition_tpu.models import las as jlas
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch.decoding import beam as tbeam
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.training import trainer as ttrainer

from test_torch_las import jax_cfg, jax_model, small_cfg
from test_torch_train import _leaves, jax_state, port_state

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def pcfg(**kw):
    return small_cfg(enc_type="pblstm", enc_units=16, num_enc_layers=2,
                     **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def batch(rng, T, L=7):
    """Three rows of ragged length (T, about 2T/3, about T/3) with labels
    that end in <EOS> and PAD tails."""
    x = rng.standard_normal((3, T, 13, 3)).astype(np.float32)
    xl = np.array([T, 2 * T // 3, T // 3], np.int32)
    y = rng.integers(3, 29, (3, L)).astype(np.int32)
    y[1, 5:] = 0
    y[2, 3], y[2, 4:] = 2, 0
    return x, xl, y, (y != 0).sum(1).astype(np.int32)


@pytest.mark.parametrize("T", [41, 44])
def test_listener_matches_jax(rng, T):
    cfg = pcfg()
    params, state = jax_model(cfg, rng)
    x, xl, _, _ = batch(rng, T)
    want, want_len, _ = jlas.listener_apply(
        params["listener"], state["listener"], x, xl, jax_cfg(cfg),
        is_training=False)
    model = convert.from_jax_params(params, state, cfg, CPU)
    with torch.no_grad():
        got, got_len = model.listener(_t(x), _t(xl))
    assert got.shape == (3, -(-(-(-T // 2)) // 2), 32)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [41, 44])
@pytest.mark.parametrize("is_training", [False, True])
def test_forward_matches_jax(rng, T, is_training):
    """las_forward: greedy and teacher-forced logits, CTC logits, alphas
    and enc_len."""
    cfg = pcfg(ctc=True)
    params, state = jax_model(cfg, rng)
    x, xl, y, _ = batch(rng, T)
    teacher = y if is_training else None
    want = jlas.las_forward(params, state, x, xl, jax_cfg(cfg), y.shape[1],
                            teacher=teacher, is_training=is_training)
    model = convert.from_jax_params(params, state, cfg, CPU)
    with torch.no_grad():
        got = tlas.las_forward(model, _t(x), _t(xl), cfg, y.shape[1],
                               teacher=None if teacher is None else _t(y),
                               is_training=is_training)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert got[4] == {}                         # no BN state


@pytest.mark.parametrize("ctc", [False, True])
def test_train_step_matches_jax(rng, ctc):
    cfg = pcfg(ctc=ctc)
    params, state = jax_model(cfg, rng)
    b = batch(rng, 41)
    jts = jax_state(cfg, params, state)
    ts = port_state(cfg, params, state)
    for _ in range(2):
        jts, jm = jtrainer.train_step(jts, b, jax_cfg(cfg), dec_steps=7)
        m = ttrainer.train_step(ts, tuple(map(_t, b)), cfg)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    have = _leaves(convert.to_jax_params(ts.model))
    want = _leaves((jts.params, jts.bn_state))
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_convert_round_trip_and_init(rng):
    """from_jax_params then to_jax_params gives the JAX tree back; the
    port's own init has JAX's parameter set, shapes and count."""
    cfg = pcfg(ctc=True)
    params, state = jax_model(cfg, rng)
    back_p, back_s = convert.to_jax_params(
        convert.from_jax_params(params, state, cfg, CPU))
    assert back_s == {"listener": {}}
    want, have = _leaves(params), _leaves(back_p)
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    jp, js = jlas.las_init(jax.random.PRNGKey(0), jax_cfg(cfg))
    assert tlas.num_params(model) == jlas.num_params(jp)
    p2, s2 = convert.to_jax_params(model)
    convert.from_jax_params(p2, s2, cfg, CPU)
    assert {k: v.shape for k, v in _leaves(p2).items()} == \
        {k: np.asarray(v).shape for k, v in _leaves(jp).items()}
    rnn = model.listener.pyr[1].birnn
    assert rnn.bias_hh_l0.eq(0).all() and not rnn.bias_hh_l0.requires_grad


@pytest.mark.parametrize("T", [41, 44])
def test_greedy_and_beam_match_jax(rng, T):
    cfg = pcfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.3)
    params, state = jax_model(cfg, rng)
    params["speller"]["out"]["b"][2] -= 2.0          # a later <EOS>
    x, xl, _, _ = batch(rng, T)
    jc = jax_cfg(cfg)
    want_logits, want_y = jtrainer.eval_forward(params, state, x, xl, jc, 8)
    model = convert.from_jax_params(params, state, cfg, CPU)
    logits, y_hat = ttrainer.eval_forward(model, _t(x), _t(xl), cfg, 8)
    np.testing.assert_array_equal(y_hat.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    max_steps = int(cfg.convert_rate * T) + 1
    want = jbeam.beam_search(params, state, x, xl, jc, max_steps=max_steps,
                             beam_size=3, logprob=True)
    got = tbeam.beam_search(model, _t(x), _t(xl), cfg, max_steps, 3, True)
    for b in range(3):
        n = int(want.lengths[b, 0])
        assert int(got.lengths[b, 0]) == n
        np.testing.assert_array_equal(got.tokens[b, 0, :n].numpy(),
                                      np.asarray(want.tokens)[b, 0, :n])
    np.testing.assert_allclose(got.scores[:, 0].numpy(),
                               np.asarray(want.scores)[:, 0], rtol=1e-4)


def test_pblstm_encoder_trains(rng):
    """tests/test_quirk_paths.py's test_pblstm_encoder_trains on the port:
    4 steps from the port's init, losses finite and falling."""
    cfg = pcfg(lr=5e-3, scheduled_sampling=False)
    ts = ttrainer.create_train_state(cfg, CPU)
    b = tuple(map(_t, batch(rng, 32)))
    losses = [ttrainer.train_step(ts, b, cfg)["loss"].item()
              for _ in range(4)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_every_config_through_serve_and_transcribe(tmp_path):
    """--enc_type pblstm --dtype bfloat16 --quantize_decoder int8 together
    reach the model through serve.main (HTTP, BatchingRecognizer) and
    transcribe.main: each text equals that of a Recognizer built by hand
    from the int8 copy of the checkpoint's model under the bf16 config."""
    import json
    import queue
    import threading
    import urllib.request

    from automatic_speech_recognition_torch import serve as serve_cli
    from automatic_speech_recognition_torch import transcribe as trans_cli
    from automatic_speech_recognition_torch.api import Recognizer
    from automatic_speech_recognition_torch.data.audio_io import (read_audio,
                                                                  write_wav)
    from automatic_speech_recognition_torch.ops import quant
    from automatic_speech_recognition_torch.training.checkpoint import (
        CheckpointManager)
    from automatic_speech_recognition_torch.utils.tokenizer import (
        CharEncoder)

    flags = ["--unit", "char", "--feat_dim", "13", "--enc_type", "pblstm",
             "--enc_units", "16", "--num_enc_layers", "2", "--dec_units",
             "32", "--num_dec_layers", "2", "--embedding_size", "16",
             "--attention_size", "16", "--mode", "loc", "--convert_rate",
             "0.12", "--dtype", "bfloat16", "--quantize_decoder", "int8",
             "--max_audio_seconds", "4", "--beam_size", "1"]
    cfg = pcfg(dtype="bfloat16", quantize_decoder="int8",
               max_audio_seconds=4)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        model.speller.out.bias[2] -= 3.0           # a later <EOS>
    CheckpointManager(str(tmp_path / "m")).save_weights(1, model)
    rec = Recognizer(quant.quantize_model(model, 30), cfg, CharEncoder(),
                     CPU)
    rng = np.random.default_rng(3)
    sigs = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
            for s in (0.6, 1.3)]
    paths = []
    for i, s in enumerate(sigs):
        paths.append(str(tmp_path / f"u{i}.wav"))
        write_wav(paths[i], s, 16000)
        sigs[i] = read_audio(paths[i])[0].astype(np.float32)

    started = queue.Queue()
    t = threading.Thread(target=serve_cli.main, args=(
        ["--device", "cpu", "--save_dir", str(tmp_path / "m"), "--port", "0",
         "--max_batch", "2", "--max_wait_ms", "5", "--warmup", "0"] + flags,
        started.put), daemon=True)
    t.start()
    httpd = started.get(timeout=120)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/transcribe"
        for p, s in zip(paths, sigs):
            req = urllib.request.Request(url, data=open(p, "rb").read(),
                                         headers={"Content-Type":
                                                  "audio/wav"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())["text"]
            bucket = -(-len(s) // 16000)
            assert got == rec.transcribe_signals([s, s],
                                                 pad_seconds=bucket)[0]
    finally:
        httpd.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()

    texts = trans_cli.main(paths + ["--device", "cpu", "--save_dir",
                                    str(tmp_path / "m")] + flags)
    assert texts == rec.transcribe(paths)
    assert any(texts)
