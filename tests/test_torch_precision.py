"""bfloat16 compute with float32 master weights on the port
(models/las.compute_cast, the trainer, beam search, checkpoints, the bf16
host feed of train / test / decode) against the JAX package's
compute_cast and tests/test_quirk_paths.py's bf16 tests.

Tolerances, stated with their reasons:
- port bf16 vs JAX bf16 (the same weights and inputs): bf16 rounds at
  other places in the two frameworks (PyTorch's softmax and matmuls
  accumulate in float32 on the CPU, XLA's in its own order), so the two
  differ by bf16 rounding noise, not by a fault.  The limit: within twice
  JAX's own bf16 rounding distance (JAX bf16 vs JAX float32, max abs) of
  JAX's bf16 result, and a relative L2 error under 0.05;
- port bf16 vs port float32: rtol 0.05 (tests/test_quirk_paths.py's);
- the host feed: bit-equal.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import glob
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.models import las as jlas
from automatic_speech_recognition_tpu.ops import quant as jquant
from automatic_speech_recognition_torch import decode as decode_cli
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.config import Config, parse_args
from automatic_speech_recognition_torch.data import shards
from automatic_speech_recognition_torch.data.pipeline import BucketedLoader
from automatic_speech_recognition_torch.decoding import beam as tbeam
from automatic_speech_recognition_torch.decoding import ctc_prefix
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.ops import quant
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.device import host_tensor
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_quirk_paths import BASE, make_batch
from test_torch_las import jax_cfg, jax_model, small_cfg

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_jax_bf16(name, got, want16, want32):
    got, want16 = got.numpy(), np.asarray(want16)
    noise = np.abs(want16 - np.asarray(want32)).max()
    assert np.abs(got - want16).max() <= 2 * noise, name
    rel = np.linalg.norm(got - want16) / np.linalg.norm(want16)
    assert rel < 0.05, (name, rel)


@pytest.mark.parametrize("enc_type,mode", [("cnn", "add"), ("cnn", "loc"),
                                           ("pblstm", "loc")])
def test_forward_bf16_matches_jax_bf16(rng, enc_type, mode):
    """Teacher-forced las_forward under bf16, BN in training mode for the
    cnn: logits, CTC logits and alphas, float32 out as in JAX."""
    cfg = small_cfg(enc_type=enc_type, mode=mode, ctc=True, dtype="bfloat16",
                    apply_bn=enc_type == "cnn",
                    enc_units=16 if enc_type == "pblstm" else 32)
    params, state = jax_model(cfg, rng)
    x = rng.standard_normal((3, 41, 13, 3)).astype(np.float32)
    xl = np.array([41, 30, 17], np.int32)
    y = rng.integers(3, 29, (3, 7)).astype(np.int32)
    want16 = jlas.las_forward(params, state, x, xl, jax_cfg(cfg), 7,
                              teacher=y, is_training=True)
    want32 = jlas.las_forward(params, state, x, xl,
                              jax_cfg(cfg.replace(dtype="float32")), 7,
                              teacher=y, is_training=True)
    model = convert.from_jax_params(params, state, cfg, CPU).train()
    with torch.no_grad():
        got = tlas.las_forward(model, _t(x), _t(xl), cfg, 7, teacher=_t(y),
                               is_training=True)
    for i, name in enumerate(("logits", "ctc_logits", "alphas")):
        assert got[i].dtype == torch.float32
        _close_to_jax_bf16(name, got[i], want16[i], want32[i])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want16[3]))
    for k, (mean, var) in got[4].items():       # BN statistics: float32
        assert mean.dtype == var.dtype == torch.float32, k


def test_compute_cast_swaps_copies_and_restores(rng):
    """Inside the cast: float32 parameters and the BiRNNs' zero bias_hh are
    bf16, BN statistics and int8 w_scale stay float32, q stays int8; a
    nested cast is a no-op; after it the very same Parameters are back.
    With int8 weights the bf16 logits still track JAX's bf16 + int8."""
    cfg = small_cfg(dtype="bfloat16", apply_bn=True)
    params, state = jax_model(cfg, rng)
    model = quant.quantize_model(
        convert.from_jax_params(params, state, cfg, CPU), cfg.vocab_size)
    before = dict(model.named_parameters())
    with tlas.compute_cast(cfg, model):
        with tlas.compute_cast(cfg, model):
            sd = model.state_dict()
    assert sd["listener.layers.0.birnn.weight_ih_l0"].dtype == torch.bfloat16
    assert sd["listener.layers.0.birnn.bias_hh_l0"].dtype == torch.bfloat16
    assert sd["speller.cells.0.bias"].dtype == torch.bfloat16
    assert sd["listener.layers.0.bn_main.mean"].dtype == torch.float32
    assert sd["speller.cells.0.w_scale"].dtype == torch.float32
    assert sd["speller.cells.0.q"].dtype == torch.int8
    after = dict(model.named_parameters())
    assert before.keys() == after.keys()
    assert all(before[k] is after[k] for k in before)
    assert all(p.dtype == torch.float32 for p in after.values())

    x = rng.standard_normal((2, 41, 13, 3)).astype(np.float32)
    xl = np.array([41, 23], np.int32)
    y = rng.integers(3, 29, (2, 6)).astype(np.int32)
    qp = jquant.quantize_model_params(params, cfg.vocab_size)
    want16 = jlas.las_forward(qp, state, x, xl, jax_cfg(cfg), 6, teacher=y)
    want32 = jlas.las_forward(qp, state, x, xl,
                              jax_cfg(cfg.replace(dtype="float32")), 6,
                              teacher=y)
    with torch.no_grad():
        got = tlas.las_forward(model, _t(x), _t(xl), cfg, 6, teacher=_t(y))
    _close_to_jax_bf16("int8 + bf16 logits", got[0], want16[0], want32[0])


def test_compute_cast_from_many_threads(rng):
    """Threads (more than cores) decoding one shared model in bf16 take
    turns in the cast: every result equals the single-threaded one, and
    the model ends with its own float32 Parameters."""
    import sys
    import threading
    cfg = small_cfg(dtype="bfloat16", enc_type="pblstm", enc_units=16)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    before = dict(model.named_parameters())
    x = _t(rng.standard_normal((2, 33, 13, 3)).astype(np.float32))
    xl = torch.tensor([33, 20])
    want, _ = trainer.eval_forward(model, x, xl, cfg, 5)
    got, errors = [], []

    def work():
        try:
            for _ in range(3):
                got.append(trainer.eval_forward(model, x, xl, cfg, 5)[0])
        except Exception as e:              # surfaced by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(got) == 3 * len(threads)
    assert all(torch.equal(g, want) for g in got)
    after = dict(model.named_parameters())
    assert all(before[k] is after[k] for k in before)
    assert not getattr(model, "_cast_active", False)


@pytest.mark.parametrize("enc_type", ["cnn", "pblstm"])
def test_bf16_trains_and_tracks_float32(rng, enc_type):
    """tests/test_quirk_paths.py's bf16 test on the port, for both
    listeners: the first loss within rtol 0.05 of float32's from the same
    state and batch, and the losses fall."""
    batch = tuple(map(_t, make_batch(rng)))
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config(**{**BASE, "dtype": dtype, "enc_type": enc_type,
                        "num_enc_layers": 2 if enc_type == "pblstm" else 1})
        ts = trainer.create_train_state(cfg, CPU)
        losses[dtype] = [trainer.train_step(ts, batch, cfg)["loss"].item()
                         for _ in range(3)]
    l16, l32 = losses["bfloat16"], losses["float32"]
    assert np.all(np.isfinite(l16))
    assert l16[0] != l32[0]                      # bf16 really ran in bf16
    np.testing.assert_allclose(l16[0], l32[0], rtol=0.05)
    assert l16[-1] < l16[0], l16


def test_bf16_state_dtypes_stable_and_checkpoint_exact(rng, tmp_path):
    """After 3 bf16 steps every parameter, BN statistic and Adam moment is
    float32 (tests/test_quirk_paths.py); the checkpoint restores that
    state exactly, and a step from the restored state equals a step from
    the original."""
    cfg = Config(**{**BASE, "dtype": "bfloat16", "apply_bn": True})
    batch = tuple(map(_t, make_batch(rng)))
    ts = trainer.create_train_state(cfg, CPU)
    for _ in range(3):
        trainer.train_step(ts, batch, cfg)
    assert all(t.dtype == torch.float32
               for t in ts.model.state_dict().values())
    moments = [v for s in ts.optimizer.adam.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(m.dtype == torch.float32 for m in moments)
    assert any(ts.model.listener.bn_conv0.mean != 0)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, ts)
    back = ckpt.restore(trainer.create_train_state(cfg, CPU))
    assert back.step == 3
    for k, v in ts.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    a = trainer.train_step(ts, batch, cfg)["loss"]
    b = trainer.train_step(back, batch, cfg)["loss"]
    assert torch.equal(a, b)


def test_bf16_eval_and_beam_carry(rng, monkeypatch):
    """eval_forward runs in bf16 (its logits differ from float32's, within
    rtol 0.05 of scale); beam search with LM fusion and joint CTC carries
    the decoder states and the previous alignment in bf16, its scores,
    the fusion LM's logits and the CTC log-probs in float32."""
    cfg = small_cfg(dtype="bfloat16", apply_lm=True, lm_weight=0.3,
                    beam_logprob=True, ctc=True, ctc_beam_weight=0.3)
    params, state = jax_model(cfg, rng)
    model = convert.from_jax_params(params, state, cfg, CPU)
    x, xl = _t(rng.standard_normal((2, 41, 13, 3)).astype(np.float32)), \
        torch.tensor([41, 27])
    l16, _ = trainer.eval_forward(model, x, xl, cfg, 6)
    l32, _ = trainer.eval_forward(model, x, xl, cfg.replace(dtype="float32"),
                                  6)
    assert l16.dtype == torch.float32 and not torch.equal(l16, l32)
    assert float((l16[:, 0] - l32[:, 0]).abs().max()) <= \
        0.05 * float(l32[:, 0].abs().max())

    seen = []
    step, lm_step, ctc_step = tlas.decode_step, tcr.lm_step, ctc_prefix.step

    def spy(sp, enc, enc_len, states, emb, align, h_proj=None):
        seen.append((enc.dtype, states.dtype, align.dtype))
        return step(sp, enc, enc_len, states, emb, align, h_proj)

    def lm_spy(*args, **kw):
        out = lm_step(*args, **kw)
        seen.append(("lm", out[0].dtype))
        return out

    def ctc_spy(x, *args):
        seen.append(("ctc", x.dtype))
        return ctc_step(x, *args)

    monkeypatch.setattr(tlas, "decode_step", spy)
    monkeypatch.setattr(tcr, "lm_step", lm_spy)
    monkeypatch.setattr(ctc_prefix, "step", ctc_spy)
    lm_cfg = tcr.LMConfig(vocab_size=28, hidden_size=16, num_layers=1)
    lm = tcr.init(lm_cfg, torch.Generator().manual_seed(0), CPU)
    res = tbeam.beam_search(model, x, xl, cfg, 5, 3, True, lm, lm_cfg)
    assert res.scores.dtype == torch.float32
    assert torch.isfinite(res.scores[:, 0]).all()
    dec = [s for s in seen if s[0] not in ("lm", "ctc")]
    assert dec and all(s == (torch.bfloat16,) * 3 for s in dec)
    side = [s for s in seen if s[0] in ("lm", "ctc")]
    assert {s[0] for s in side} == {"lm", "ctc"}
    assert all(s[1] == torch.float32 for s in side)
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---- the bf16 host feed: the loader's ml_dtypes.bfloat16 batches


def test_host_tensor_keeps_bf16_bits():
    a = (np.random.default_rng(0).standard_normal((3, 5, 2)) * 100) \
        .astype(np.float32).astype(ml_dtypes.bfloat16)
    t = host_tensor(a)
    assert t.dtype == torch.bfloat16 and t.shape == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy()
                                  .view(np.uint16), a.view(np.uint16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    i = np.arange(4, dtype=np.int32)
    assert torch.equal(host_tensor(i), torch.arange(4, dtype=torch.int32))


# the pblstm listener under bf16: both configurations through the CLIs
FLAGS = ["--unit", "char", "--feat_dim", "13", "--enc_type", "pblstm",
         "--enc_units", "16", "--num_enc_layers", "2",
         "--dec_units", "16", "--num_dec_layers", "1",
         "--embedding_size", "8", "--attention_size", "8", "--mode", "loc",
         "--loc_kernel_size", "5", "--loc_num_channels", "2",
         "--dropout_rate", "0.0", "--scheduled_sampling", "False",
         "--dtype", "bfloat16", "--convert_rate", "0.2",
         "--bucket_boundaries_train", "64", "--bucket_boundaries_eval", "64",
         "--bucket_batch_sizes", "4", "--max_tokenlen_train", "12"]


@pytest.fixture(scope="module")
def feature_shards(tmp_path_factory):
    """Feature shards ((T, 13, 3) float32 records, 20-60 frames) for the
    train and dev splits."""
    d = str(tmp_path_factory.mktemp("bf16feed"))
    rng = np.random.default_rng(5)
    tok = CharEncoder()
    for split, n in (("train", 8), ("dev", 5)):
        feats = [rng.standard_normal((int(rng.integers(20, 60)), 13, 3))
                 .astype(np.float32) * 3 for _ in range(n)]
        ids = [np.asarray(tok.encode("AB C", with_eos=True), np.int32)
               for _ in range(n)]
        shards.write_shard(os.path.join(d, f"{split}-0.arsh"), feats, ids)
    return d


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_bf16_feed_reaches_train_bit_exact(feature_shards, tmp_path,
                                           monkeypatch):
    d = feature_shards
    seen = []
    step = trainer.train_step

    def spy(ts, batch, cfg, dec_steps=None, **kwargs):
        seen.append(batch[0].clone())
        return step(ts, batch, cfg, dec_steps, **kwargs)

    monkeypatch.setattr(trainer, "train_step", spy)
    argv = FLAGS + ["--shard_dir", d, "--save_dir", str(tmp_path / "m"),
                    "--summary_dir", str(tmp_path / "s"), "--epoch", "1",
                    "--steps_per_epoch", "2"]
    ts, hist = train_cli.main(["--device", "cpu"] + argv)
    assert ts.step == 2 and np.all(np.isfinite(hist["loss"]))
    cfg = parse_args(argv).replace(vocab_size=30)
    it = iter(BucketedLoader(sorted(glob.glob(f"{d}/train-*.arsh")), cfg,
                             is_training=True, seed=cfg.seed))
    for got in seen:
        want = next(it)[0]
        assert want.dtype == ml_dtypes.bfloat16
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), want.view(np.uint16))


def test_bf16_feed_reaches_test_and_decode(feature_shards, tmp_path,
                                           monkeypatch, capsys):
    """test: the loader's bf16 batches reach eval_forward bit for bit.
    decode: its feature batches stay float32 on the host, and the model's
    cast gives the bytes the loader's host cast gives."""
    d = feature_shards
    model_dir = str(tmp_path / "m")
    cfg = parse_args(FLAGS).replace(vocab_size=30)
    CheckpointManager(model_dir).save_weights(
        1, tlas.init(cfg, torch.Generator().manual_seed(0), CPU))
    seen = []
    fwd = trainer.eval_forward

    def spy(model, audio, audiolen, cfg, dec_steps):
        seen.append(audio.clone())
        return fwd(model, audio, audiolen, cfg, dec_steps)

    monkeypatch.setattr(trainer, "eval_forward", spy)
    res = test_cli.main(["--device", "cpu"] + FLAGS + [
        "--shard_dir", d, "--split", "dev", "--save_dir", model_dir,
        "--log_dir", str(tmp_path / "log")])
    assert res.utterances == 5 and res.skipped == 0
    batches = list(BucketedLoader([f"{d}/dev-0.arsh"], cfg,
                                  is_training=False))
    assert len(seen) == len(batches) == 2
    for got, (want, *_) in zip(seen, batches):
        assert want.dtype == ml_dtypes.bfloat16
        # a partial batch is padded with rows after the loader's
        np.testing.assert_array_equal(_bits(got[:len(want)]),
                                      want.view(np.uint16))

    fed = []
    search = tbeam.beam_search

    def beam_spy(model, feats, *args):
        fed.append(feats.clone())
        return search(model, feats, *args)

    monkeypatch.setattr(tbeam, "beam_search", beam_spy)
    wer = decode_cli.main(["--device", "cpu"] + FLAGS + [
        "--shard_dir", d, "--feat_dir", str(tmp_path / "none"),
        "--split", "dev", "--save_dir", model_dir,
        "--log_dir", str(tmp_path / "dlog"), "--beam_size", "2",
        "--decode_batch", "5", "--decode_pad_quantum", "16"])
    assert np.isfinite(wer) and "WER: " in capsys.readouterr().out
    assert len(fed) == 1 and fed[0].dtype == torch.float32
    host = fed[0].numpy().astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_bits(fed[0].to(torch.bfloat16)),
                                  host.view(np.uint16))
