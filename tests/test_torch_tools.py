"""The port's recipe tools (automatic_speech_recognition_torch/tools/)
against the repository's tools/ on the same inputs:

- average_checkpoints: the uniform float32 mean of the port's state
  dicts, equal to the JAX tool's average_trees on the converted trees
  (mirrors tests/test_checkpoint_averaging.py); a missing epoch raises;
- wer_ci: the same JSON for the same files and seed;
- synth_corpus and degrade_corpus: byte-equal FLACs and transcripts for
  the same seed;
- error_analysis and study_report (plain copies): the same report on the
  port's own test_pred.txt / test_gt.txt and summary directory;
- the recipe scripts synth_12k_recipe.sh and pblstm_r5.sh: run with
  python3 shadowed by a recorder, each stage's flags equal the JAX
  script's, but for --steps_per_dispatch 16, which the port refuses.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import filecmp
import json
import os
import shutil
import stat
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.tools import average_checkpoints as tavg
from automatic_speech_recognition_torch.tools import error_analysis as tea
from automatic_speech_recognition_torch.tools import study_report as tsr
from automatic_speech_recognition_torch.tools import wer_ci as twer
from automatic_speech_recognition_torch.training import trainer as ttrainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import average_checkpoints as javg  # noqa: E402
import error_analysis as jea  # noqa: E402
import study_report as jsr  # noqa: E402
import wer_ci as jwer  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(unit="char", feat_dim=8, enc_type="cnn", enc_units=16,
            num_enc_channels=4, num_enc_layers=1, dec_units=16,
            num_dec_layers=1, embedding_size=8, attention_size=8,
            mode="add", dropout_rate=0.0, scheduled_sampling=False,
            apply_bn=True)


# ------------------------------------------------------ checkpoint average


def _three_epochs(save_dir):
    """Epochs 1-3 with different weights and BN statistics (init seeds 0,
    1, 2), epoch 3 at step 7 with an Adam state."""
    cfg = Config(**TINY, save_dir=save_dir, vocab_size=30)
    mgr = CheckpointManager(save_dir)
    states = []
    for epoch, seed in ((1, 0), (2, 1), (3, 2)):
        ts = ttrainer.create_train_state(cfg.replace(seed=seed), CPU)
        with torch.no_grad():
            for name, buf in ts.model.named_buffers():
                if name.endswith(("mean", "var")):
                    buf.uniform_(0.5, 2.0)
        ts.step = 2 * epoch + 1
        if epoch == 3:
            ts.optimizer.update([torch.ones_like(p)
                                 for p in ts.optimizer.params])
        mgr.save(epoch, ts)
        states.append(ts)
    return cfg.replace(vocab_size=0), states


def test_average_trees_is_uniform_mean():
    a = {"w": torch.full((2, 2), 1.0), "b": torch.tensor([0.0]),
         "h": torch.tensor([1.0], dtype=torch.bfloat16)}
    b = {"w": torch.full((2, 2), 3.0), "b": torch.tensor([4.0]),
         "h": torch.tensor([2.0], dtype=torch.bfloat16)}
    avg = tavg.average_trees([a, b])
    torch.testing.assert_close(avg["w"], torch.full((2, 2), 2.0))
    torch.testing.assert_close(avg["b"], torch.tensor([2.0]))
    assert avg["h"].dtype == torch.bfloat16 and avg["h"].item() == 1.5
    with pytest.raises(KeyError, match="c"):
        tavg.average_trees([a, {**b, "c": torch.zeros(1)}])


def test_average_checkpoints_end_to_end(tmp_path):
    cfg, states = _three_epochs(str(tmp_path / "src"))
    out = str(tmp_path / "avg")
    avg = tavg.main([f"--{k}={v}" for k, v in TINY.items()]
                    + ["--save_dir", cfg.save_dir, "--avg_epochs", "1,2",
                       "--avg_out", out])
    for k, v in avg["model"].items():
        a, b = (s.model.state_dict()[k] for s in states[:2])
        torch.testing.assert_close(v, (a + b) / 2, rtol=1e-6, atol=1e-7)
    # step and optimizer come from the newest source epoch (2)
    assert avg["step"] == states[1].step == 5
    # the averaged checkpoint restores through the standard path (epoch 1)
    assert CheckpointManager(out).all_epochs() == [1]
    restored = ttrainer.create_train_state(cfg.replace(vocab_size=30), CPU)
    CheckpointManager(out).restore(restored, epoch=1)
    assert restored.step == 5
    for k, v in avg["model"].items():
        assert torch.equal(restored.model.state_dict()[k], v)
    # a missing epoch raises, naming what there is; so do weights that
    # do not fit the model the flags describe
    with pytest.raises(FileNotFoundError, match="epoch 4 not found"):
        tavg.average_checkpoints(cfg, [2, 4], str(tmp_path / "bad"))
    with pytest.raises(RuntimeError, match="size mismatch"):
        tavg.average_checkpoints(cfg.replace(enc_units=32), [1, 2],
                                 str(tmp_path / "bad2"))


def test_average_keeps_the_newest_payload_as_saved(tmp_path):
    """The generator states are copied as they were written, whatever the
    device that wrote them (a CUDA generator's state is 16 bytes, a CPU
    one's 5056): averaging is host arithmetic on the weights alone."""
    cfg, _ = _three_epochs(str(tmp_path / "src"))
    mgr = CheckpointManager(cfg.save_dir)
    payload = mgr.load_payload(3)
    payload["generator"] = torch.arange(16, dtype=torch.uint8)
    mgr.write_payload(3, payload)
    avg = tavg.average_checkpoints(cfg, [2, 3], str(tmp_path / "avg"))
    written = CheckpointManager(str(tmp_path / "avg")).load_payload(1)
    assert torch.equal(written["generator"], payload["generator"])
    assert written["optimizer"]["count"] == 1 and avg["step"] == 7


def test_average_of_the_last_epochs_equals_the_jax_tool(tmp_path):
    """No --avg_epochs: the last 5 (here all 3); the mean equals JAX's
    average_trees over the converted (params, bn_state) trees, bit for
    bit, and the newest epoch's optimizer state and step are kept."""
    cfg, states = _three_epochs(str(tmp_path / "src"))
    avg = tavg.average_checkpoints(cfg, [], str(tmp_path / "avg"))
    trees = [convert.to_jax_params(s.model) for s in states]
    want = (javg.average_trees([t[0] for t in trees]),
            javg.average_trees([t[1] for t in trees]))
    model = ttrainer.create_train_state(cfg.replace(vocab_size=30),
                                        CPU).model
    model.load_state_dict(avg["model"])
    got = convert.to_jax_params(model)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))
    assert avg["step"] == 7 and avg["optimizer"]["count"] == 1
    newest = states[2].optimizer.state_dict()["adam"]["state"]
    for i, st in avg["optimizer"]["adam"]["state"].items():
        assert torch.equal(st["exp_avg"], newest[i]["exp_avg"])


# ------------------------------------------------------------- WER tools


REFS = ["THE CAT SAT", "A DOG RAN HOME", "HELLO WORLD", "ONE TWO THREE",
        "SHE SANG", "GO NOW"]
HYPS = ["THE CAT SAT", "A DOG HOME", "HELLO WORD", "ONE TO THREE FOUR",
        "SHE SANG", "NO"]
HYPS2 = ["THE CAT SAT", "A DOG RAN HOME", "HELLO WORLD", "ONE TWO THREE",
         "HE SANG", "GO"]


def test_wer_ci_prints_the_jax_tools_json(tmp_path, capsys):
    for name, lines in (("ref", REFS), ("a", HYPS), ("b", HYPS2)):
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    r, a, b = (str(tmp_path / n) for n in ("ref", "a", "b"))
    for extra in ([], ["--hyp2", b], ["--cer", "--seed", "3"]):
        argv = ["--ref", r, "--hyp", a, "--n_boot", "500", "--json"] + extra
        got = twer.main(argv)
        got_out = capsys.readouterr().out
        want = jwer.main(argv)
        assert capsys.readouterr().out == got_out
        assert json.loads(got_out) == got == want


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's train (10 steps over raw-audio shards, with a summary
    directory) and test (test_pred.txt / test_gt.txt) on the CPU."""
    d = str(tmp_path_factory.mktemp("run"))
    cli_shards(d, np.random.default_rng(0))
    for k in range(2):
        os.rename(os.path.join(d, f"train-{k}.arsh"),
                  os.path.join(d, f"dev-{k}.arsh"))
    cli_shards(d, np.random.default_rng(1))
    train_cli.main(cli_args(d) + ["--epoch", "2", "--steps_per_epoch", "5"])
    res = test_cli.main(cli_args(d) + ["--split", "dev", "--log_dir",
                                       d + "/log"])
    assert res.utterances == 16
    return d


def test_error_analysis_reads_the_ports_test_dumps(port_run, capsys):
    argv = ["--ref", f"{port_run}/log/test_gt.txt", "--hyp",
            f"{port_run}/log/test_pred.txt", "--json", "--cer"]
    tea.main(argv)
    got = capsys.readouterr().out
    jea.main(argv)
    assert capsys.readouterr().out == got
    rep = json.loads(got)
    assert rep["n_utts"] == 16 and rep["n_ref_tokens"] > 0
    tea.main(argv[:-2] + ["--examples", "2"])
    assert "WER" in capsys.readouterr().out


def test_study_report_reads_the_ports_summary(port_run, capsys):
    got = tsr.main([f"{port_run}/summary"])
    assert capsys.readouterr().out
    assert got == jsr.main([f"{port_run}/summary"])
    assert got[0]["first_step"] == 1 and got[0]["last_step"] == 10
    assert np.isfinite(got[0]["final_loss"])


# ----------------------------------------------------------- corpus tools


def _tool(cmd, cwd):
    r = subprocess.run([sys.executable] + cmd, cwd=cwd, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-3000:]


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files), \
        (cmp.left_only, cmp.right_only, cmp.diff_files)
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same degraded, pseudo-word corpus from each package's
    synth_corpus, then each corpus degraded again by its degrade_corpus."""
    d = tmp_path_factory.mktemp("corpus")
    flags = ["--train_utts", "3", "--dev_utts", "2", "--test_utts", "1",
             "--train_speakers", "2", "--eval_speakers", "1", "--seed", "5",
             "--pseudo_words", "20", "--noise_snr", "5,20", "--reverb_p",
             "0.5"]
    _tool(["tools/synth_corpus.py", "--out", str(d / "jax")] + flags, REPO)
    _tool(["-m", "automatic_speech_recognition_torch.tools.synth_corpus",
           "--out", str(d / "port")] + flags, str(d))
    deg = ["--noise_snr", "0,10", "--noise_kind", "white", "--reverb_p",
           "1.0", "--seed", "2"]
    _tool(["tools/degrade_corpus.py", "--in_dir", str(d / "jax"),
           "--out_dir", str(d / "jax_deg")] + deg, REPO)
    _tool(["-m", "automatic_speech_recognition_torch.tools.degrade_corpus",
           "--in_dir", str(d / "port"), "--out_dir", str(d / "port_deg")]
          + deg, str(d))
    return d


def test_synth_corpus_writes_the_jax_tools_bytes(corpora):
    flacs = sorted(p.relative_to(corpora / "port")
                   for p in (corpora / "port").rglob("*.flac"))
    assert len(flacs) == 6
    assert len(list((corpora / "port").rglob("*.trans.txt"))) >= 3
    _same_tree(corpora / "jax", corpora / "port")


def test_degrade_corpus_writes_the_jax_tools_bytes(corpora):
    _same_tree(corpora / "jax_deg", corpora / "port_deg")
    before = next((corpora / "port").rglob("*.flac")).read_bytes()
    rel = next((corpora / "port").rglob("*.flac")).relative_to(
        corpora / "port")
    assert (corpora / "port_deg" / rel).read_bytes() != before


# --------------------------------------------------------- recipe scripts


RECORDER = """#!{python}
import json, os, sys
with open(os.environ["RECORD"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
"""


def _recorded(root, script, stages, tmp_path, tag):
    """Each python3 command `script` runs (supervised ones included), as
    (stage module, flags)."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    rec = bindir / "python3"
    rec.write_text(RECORDER.format(python=sys.executable))
    rec.chmod(rec.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / f"{tag}.jsonl"
    env = {**os.environ, "RECORD": str(log),
           "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}"}
    r = subprocess.run(["bash", str(root / script)] + stages, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    calls = []
    for line in log.read_text().splitlines():
        argv = json.loads(line)
        if argv[0] == "-m":     # the port: -m <package>[.tools].<stage>
            calls.append((argv[1].rsplit(".", 1)[1], argv[2:]))
        else:                   # the JAX package: [tools/]<stage>.py
            calls.append((os.path.basename(argv[0])[:-3], argv[1:]))
    return calls


@pytest.mark.parametrize("script,stages", [
    ("synth_12k_recipe.sh", []),
    ("pblstm_r5.sh", ["train", "eval", "final", "beam"])])
def test_recipe_script_runs_the_jax_scripts_stages(tmp_path, script, stages):
    """Both scripts cd to their repository root, so each runs from a copy
    of its tools/ inside a scratch root."""
    root = tmp_path / "root"
    port_tools = root / "automatic_speech_recognition_torch" / "tools"
    port_tools.mkdir(parents=True)
    (root / "tools").mkdir()
    for name in (script, "train_supervised.sh"):
        shutil.copy(os.path.join(REPO, "tools", name), root / "tools")
        shutil.copy(os.path.join(REPO, "automatic_speech_recognition_torch",
                                 "tools", name), port_tools)
    want = _recorded(root, f"tools/{script}", stages, tmp_path, "jax")
    got = _recorded(root, f"automatic_speech_recognition_torch/tools/"
                    f"{script}", stages, tmp_path, "port")
    assert len(want) >= 6 and [s for s, _ in got] == [s for s, _ in want]
    dropped = 0
    for (stage, flags), (_, jflags) in zip(got, want):
        if "--steps_per_dispatch" in jflags:
            i = jflags.index("--steps_per_dispatch")
            assert jflags[i + 1] == "16" and stage == "train"
            jflags = jflags[:i] + jflags[i + 2:]
            dropped += 1
        assert flags == jflags, stage
    assert dropped == 1
