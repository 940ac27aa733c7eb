"""A TPU run's checkpoints carried to the port: the JAX package's orbax
checkpoints (training/checkpoint.CheckpointManager) through
tools/export_jax_checkpoint.py into automatic_speech_recognition_torch.
import_checkpoint, for the cnn and the pblstm listener, with and without
optax.MultiSteps, and a directory written by the JAX train_lm.py.

After the round trip, on the JAX state the checkpoint holds:
- greedy tokens equal JAX's trainer.eval_forward, logits within
  tests/test_torch_las.py's rtol 1e-5 / atol 1e-5;
- Adam's moments, its count, the MultiSteps counter and accumulated
  gradient and the train step are equal (layout changes only);
- one resumed train step against JAX's next step: loss and gradient norm
  within rtol 1e-5 / atol 2e-6 (the parameters are equal, so only sums
  in another order differ), then the parameters by
  tests/test_torch_train.py's rule (rtol 1e-4 / atol 1e-5; Adam's
  bias correction is float32 in optax and float64 in torch);
- the LM directory: load_lm_dir's logits within rtol 1e-5 / atol 1e-6,
  and a resumed LM step within test_torch_lm_train.py's rtol 1e-5 /
  atol 2e-6.
A missing key, a wrong shape and an unknown format version raise, naming
it.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu import config as jconfig
from automatic_speech_recognition_tpu.models import char_rnn as jcr
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_tpu.training.checkpoint import (
    CheckpointManager as JCheckpointManager)
from automatic_speech_recognition_torch import import_checkpoint
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.training import trainer as ttrainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

from test_torch_las import jax_cfg, jax_model, small_cfg
from test_torch_train import _assert_params_match, jax_state, make_batch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import export_jax_checkpoint  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=2e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


CASES = {"cnn": dict(), "cnn_multisteps": dict(grad_accum_steps=2),
         "pblstm": dict(enc_type="pblstm", enc_units=16, num_enc_layers=2)}


def jax_run(d, cfg, rng):
    """Three JAX train steps from jittered params; epoch 1 saved after the
    first (MultiSteps: second) step, epoch 2 after the third, config.json
    beside them as train.py writes it.  Returns the JAX state at epoch 2
    and the batches."""
    params, state = jax_model(cfg, rng)
    jts = jax_state(cfg, params, state)
    jconfig.save_config_snapshot(jax_cfg(cfg), d)
    mgr = JCheckpointManager(d)
    batches = [make_batch(rng) for _ in range(4)]
    first = 2 if cfg.grad_accum_steps > 1 else 1
    for i, batch in enumerate(batches[:3]):
        jts, _ = jtrainer.train_step(jts, batch, jax_cfg(cfg), dec_steps=7)
        if i + 1 in (first, 3):
            mgr.save(1 if i + 1 == first else 2, jax.device_get(jts))
    mgr.close()
    return jax.device_get(jts), batches


def round_trip(tmp_path, cfg, rng):
    jdir, export, out = (str(tmp_path / n) for n in ("jax", "export", "port"))
    jts, batches = jax_run(jdir, cfg, rng)
    manifest = export_jax_checkpoint.main(["--save_dir", jdir,
                                           "--out", export])
    assert import_checkpoint.main(["--device", "cpu", "--export_dir", export,
                                   "--out", out]) == [1, 2]
    return jts, batches, manifest, export, out


@pytest.fixture(scope="module", params=sorted(CASES))
def imported(request, tmp_path_factory):
    cfg = small_cfg(**CASES[request.param])
    rng = np.random.default_rng(0)
    return (cfg,) + round_trip(tmp_path_factory.mktemp(request.param), cfg,
                               rng)


def port_state(cfg, out, epoch=2):
    ts = ttrainer.create_train_state(cfg, CPU)
    assert CheckpointManager(out).restore(ts, epoch=epoch) is ts
    return ts


def test_export_manifest_names_every_key(imported):
    cfg, jts, _, manifest, export, _ = imported
    assert manifest["format_version"] == 1 and manifest["kind"] == "las"
    assert [(e["dir"], e["epoch"]) for e in manifest["epochs"]] == \
        [(".", 1), (".", 2)]
    assert manifest["epochs"][1]["step"] == 3 == int(jts.step)
    keys = set(manifest["epochs"][1]["keys"])
    with np.load(os.path.join(export, "2.npz")) as f:
        assert set(f.files) == keys
    assert {"step", "opt/adam/count", "params/speller/out/w",
            "opt/adam/mu/speller/out/w", "opt/adam/nu/speller/out/w"} <= keys
    assert any(k.startswith("bn_state/") for k in keys) == \
        (cfg.enc_type == "cnn")
    assert ("opt/multisteps/acc/speller/out/w" in keys) == \
        (cfg.grad_accum_steps > 1)
    assert not any("rng" in k for k in keys)
    assert json.loads(open(os.path.join(export, "manifest.json")).read()) \
        == manifest


def test_greedy_tokens_and_logits_equal_jax(imported):
    cfg, jts, _, _, _, out = imported
    x = np.random.default_rng(5).standard_normal((2, 41, 13, 3)).astype(
        np.float32)
    xl = np.array([41, 21], np.int32)
    want_logits, want_y = jtrainer.eval_forward(jts.params, jts.bn_state, x,
                                                xl, jax_cfg(cfg), 8)
    model = port_state(cfg, out).model.eval()
    got_logits, got_y = ttrainer.eval_forward(model, _t(x), _t(xl), cfg, 8)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)


def test_adam_state_counts_and_step_carry_over(imported):
    cfg, jts, _, _, _, out = imported
    ts = port_state(cfg, out)
    opt = jts.opt_state
    if cfg.grad_accum_steps > 1:
        assert ts.optimizer.mini_step == int(opt.mini_step) == 1
        acc = convert.from_jax_params(jax.device_get(opt.acc_grads),
                                      jts.bn_state, cfg, CPU)
        for a, (name, _) in zip(ts.optimizer.acc,
                                ts.model.named_parameters()):
            np.testing.assert_array_equal(a.numpy(),
                                          acc.state_dict()[name].numpy())
        opt = opt.inner_opt_state
    adam = [s for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    assert ts.optimizer.count == int(adam.count) > 0
    assert ts.step == int(jts.step) == 3
    moments = {k: convert.from_jax_params(getattr(adam, k), jts.bn_state,
                                          cfg, CPU).state_dict()
               for k in ("mu", "nu")}
    for name, p in ts.model.named_parameters():
        st = ts.optimizer.adam.state[p]
        assert st["step"].item() == int(adam.count)
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      moments["mu"][name].numpy())
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      moments["nu"][name].numpy())


def test_resumed_step_matches_jax_next_step(imported):
    cfg, jts, batches, _, _, out = imported
    ts = port_state(cfg, out)
    jts, jm = jtrainer.train_step(jts, batches[3], jax_cfg(cfg), dec_steps=7)
    m = ttrainer.train_step(ts, tuple(map(_t, batches[3])), cfg)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k,
                                   **STEP_TOL)
    assert ts.step == int(jts.step) == 4
    _assert_params_match(ts, jts, cfg, 4)


def test_imported_save_dir_holds_the_config_and_every_epoch(imported):
    """config.json (what train's check_model_config and
    --use_saved_config read) and both epochs, each at its own step."""
    cfg, _, _, _, _, out = imported
    assert json.load(open(os.path.join(out, "config.json")))["enc_type"] \
        == cfg.enc_type
    assert CheckpointManager(out).all_epochs() == [1, 2]
    ts = port_state(cfg, out, epoch=1)
    assert ts.step == (2 if cfg.grad_accum_steps > 1 else 1)


# ------------------------------------------------------------------ LM


CORPUS = ("the quick brown fox jumps over the lazy dog. " * 30
          + "she sells sea shells by the sea shore! " * 30)


@pytest.fixture(scope="module")
def lm_import(tmp_path_factory):
    """A directory written by the JAX train_lm.py, exported and imported."""
    import train_lm as jtrain_lm
    d = tmp_path_factory.mktemp("lm")
    (d / "corpus.txt").write_text(CORPUS)
    jtrain_lm.main(["--data_file", str(d / "corpus.txt"), "--output_dir",
                    str(d / "jax"), "--num_epochs", "2", "--hidden_size",
                    "24", "--batch_size", "4", "--num_unrollings", "8",
                    "--learning_rate", "1e-2"])
    manifest = export_jax_checkpoint.main(["--lm", "--save_dir",
                                           str(d / "jax"), "--out",
                                           str(d / "export")])
    import_checkpoint.main(["--device", "cpu", "--export_dir",
                            str(d / "export"), "--out", str(d / "port")])
    return d, manifest


def _jax_lm(d, sub, epoch):
    result = json.load(open(d / "jax" / "result.json"))
    cfg = jcr.LMConfig(**result["params"])
    template = jcr.create_lm_train_state(jax.random.PRNGKey(0), cfg)
    mgr = JCheckpointManager(str(d / "jax" / "lang" / sub))
    ts = jax.device_get(mgr.restore(template, epoch=epoch))
    mgr.close()
    return cfg, ts


def test_lm_dir_round_trips(lm_import, rng):
    d, manifest = lm_import
    assert manifest["kind"] == "lm"
    result = json.load(open(d / "jax" / "result.json"))
    assert [(e["dir"], e["epoch"]) for e in manifest["epochs"]] == \
        [("save_model", 1), ("save_model", 2),
         ("best_model", result["best_model"])]
    for name in ("result.json", "vocab.json"):
        assert (d / "port" / name).read_text() == \
            (d / "jax" / name).read_text()
    jcfg, jts = _jax_lm(d, "best_model", result["best_model"])
    lm, cfg, v2i, _ = tcr.load_lm_dir(str(d / "port"))
    assert cfg.hidden_size == 24 and len(v2i) == 28
    ids = rng.integers(0, 28, (3, 9)).astype(np.int32)
    want, _ = jcr.lm_apply(jts.params, jcfg, ids, jcr.zero_state(jcfg, 3))
    with torch.no_grad():
        got, _ = tcr.lm_apply(lm, cfg, _t(ids), tcr.zero_state(cfg, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_lm_resumed_step_matches_jax(lm_import, rng):
    d, _ = lm_import
    jcfg, jts = _jax_lm(d, "save_model", 2)
    cfg = tcr.LMConfig.from_json(json.dumps(json.load(
        open(d / "jax" / "result.json"))["params"]))
    ts = tcr.create_lm_train_state(cfg, 0, CPU)
    CheckpointManager(str(d / "port" / "lang" / "save_model")).restore(
        ts, epoch=2)
    assert ts.step == int(jts.step) > 0
    x = rng.integers(0, 28, (4, 8)).astype(np.int32)
    y = rng.integers(0, 28, (4, 8)).astype(np.int32)
    jts2, jloss, _ = jcr.lm_train_step(jts, x, y, jcr.zero_state(jcfg, 4),
                                       jcfg)
    loss, _ = tcr.lm_train_step(ts, _t(x), _t(y), tcr.zero_state(cfg, 4),
                                cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), **STEP_TOL)
    have = convert.to_jax_lm_params(ts.model)
    want = jax.device_get(jts2.params)
    assert jax.tree_util.tree_structure(have) == \
        jax.tree_util.tree_structure(want)
    for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(have),
                          jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b),
                                   err_msg=jax.tree_util.keystr(kp),
                                   **STEP_TOL)


# ------------------------------------------------------------ refusals


def _edit_export(src, dst, edit_arrays=None, edit_manifest=None):
    """A copy of export `src` at `dst` with epoch 2's arrays and the
    manifest changed."""
    os.makedirs(dst)
    manifest = json.load(open(os.path.join(src, "manifest.json")))
    manifest["epochs"] = manifest["epochs"][1:]
    with np.load(os.path.join(src, "2.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    if edit_arrays:
        edit_arrays(arrays)
    manifest["epochs"][0]["keys"] = sorted(arrays)
    if edit_manifest:
        edit_manifest(manifest)
    np.savez(os.path.join(dst, "2.npz"), **arrays)
    json.dump(manifest, open(os.path.join(dst, "manifest.json"), "w"))
    return dst


@pytest.mark.parametrize("key", ["params/speller/out/b",
                                 "opt/adam/nu/speller/out/w", "step"])
def test_missing_key_raises_naming_it(imported, tmp_path, key):
    _, _, _, _, export, _ = imported
    bad = _edit_export(export, str(tmp_path / "bad"),
                       lambda a: a.pop(key))
    with pytest.raises(KeyError, match=key.split("/", 1)[-1]):
        import_checkpoint.main(["--device", "cpu", "--export_dir", bad,
                                "--out", str(tmp_path / "out")])


def test_extra_key_and_wrong_shape_raise_naming_the_key(imported, tmp_path):
    _, _, _, _, export, _ = imported

    def extra(a):
        a["opt/adam/mu/speller/extra/w"] = np.zeros((2, 2), np.float32)

    bad = _edit_export(export, str(tmp_path / "extra"), extra)
    with pytest.raises(KeyError, match="opt/adam/mu/speller/extra/w"):
        import_checkpoint.main(["--device", "cpu", "--export_dir", bad,
                                "--out", str(tmp_path / "out1")])

    def misshapen(a):
        a["opt/adam/mu/speller/out/w"] = a["opt/adam/mu/speller/out/w"][:-1]

    bad = _edit_export(export, str(tmp_path / "shape"), misshapen)
    with pytest.raises(ValueError, match="opt/adam/mu/speller/out/w"):
        import_checkpoint.main(["--device", "cpu", "--export_dir", bad,
                                "--out", str(tmp_path / "out2")])


def test_unknown_format_version_raises(imported, tmp_path):
    _, _, _, _, export, _ = imported
    bad = _edit_export(export, str(tmp_path / "v2"), None,
                       lambda m: m.update(format_version=2))
    with pytest.raises(ValueError, match="format_version 2"):
        import_checkpoint.main(["--device", "cpu", "--export_dir", bad,
                                "--out", str(tmp_path / "out")])


def test_import_refuses_a_missing_gpu(imported, tmp_path, monkeypatch):
    """The default device is cuda, and a GPU request never falls back to
    the CPU."""
    _, _, _, _, export, _ = imported
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_checkpoint.main(["--export_dir", export,
                                "--out", str(tmp_path / "out")])
