"""automatic_speech_recognition_torch/run.sh, the port's recipe chain,
driven stage by stage on a synthesized corpus at tests/test_run_sh.py's
tiny overrides with RUN_DEVICE=cpu, mirroring that test of run.sh.

The tier-1 case runs every stage of the default chain, decode_lm
included (so with char units: the fusion LM is a char LM), then the
recommended train_rec and decode_rec, from a scratch working directory,
and asserts each stage's artifacts and a `WER:` line (the synth stage
writes run.sh's 4,600-utterance corpus; the tiny corpus comes from the
same tool with smaller counts).  The slow case runs run.sh and the port's chain on the same
corpus with the same overrides and compares the two artifact trees: file
names, feature shapes, shard counts and records, the vocabulary.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RUN = os.path.join(REPO, "automatic_speech_recognition_torch", "run.sh")
STAGES = {
    "subword": ["subword/bpe-vocab.json", "subword/bpe-merges.txt",
                "subword/corpus_all.txt"],
    "preprocess": ["data/LibriSpeech/features/dev-featlen.npy"],
    "shards": ["data/shards"],
    "train": ["model/las/config.json", "model/las/1.pt"],
    "test": ["log/test_pred.txt", "log/test_gt.txt"],
    "lm": ["lang/output/result.json"],
    "decode": ["log/decode_pred.txt"],
    "decode_lm": ["log/decode_pred.txt"],
}


def _run(cmd, cwd, env=None, timeout=600):
    e = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
         "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
         **(env or {})}
    r = subprocess.run(cmd, cwd=cwd, env=e, timeout=timeout,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    assert r.returncode == 0, f"{' '.join(cmd)} failed:\n{r.stdout[-4000:]}"
    return r.stdout


def _corpus(raw, cwd, port=True):
    tool = (["-m", "automatic_speech_recognition_torch.tools.synth_corpus"]
            if port else [os.path.join(REPO, "tools", "synth_corpus.py")])
    _run([sys.executable] + tool + [
        "--out", str(raw), "--train_utts", "8", "--dev_utts", "2",
        "--test_utts", "2", "--train_speakers", "2", "--eval_speakers", "2"],
        cwd, {"PYTHONPATH": REPO})


def _env(work, raw, **extra):
    """tests/test_run_sh.py's overrides, the summaries kept in `work`."""
    return {
        "RUN_WORKDIR": str(work), "RUN_DEVICE": "cpu",
        "RUN_BPE_SIZE": "80", "RUN_FEAT_DIM": "8",
        "RUN_ENC_UNITS": "16", "RUN_DEC_UNITS": "16",
        "RUN_EMBEDDING_SIZE": "8", "RUN_ATTENTION_SIZE": "8",
        "RUN_NUM_ENC_LAYERS": "1", "RUN_NUM_DEC_LAYERS": "1",
        "RUN_LR": "1e-3", "RUN_EPOCH": "1", "RUN_BEAM_SIZE": "4",
        "RUN_CONVERT_RATE": "0.3", "RUN_LM_EPOCHS": "1",
        "RUN_LM_FLAGS": "--batch_size 2 --num_unrollings 10 "
                        "--train_frac 0.6 --valid_frac 0.2",
        "RUN_EXTRA_FLAGS": " ".join([
            "--train_100hr_corpus_dir", str(raw / "train"),
            "--dev_data_dir", str(raw / "dev"),
            "--test_data_dir", str(raw / "test"),
            "--summary_dir", str(work / "summary"),
            "--num_enc_channels 4 --steps_per_epoch 20",
            "--bucket_batch_sizes 2,2,2,2,2,2,2,2,2",
            "--stall_timeout_s 0",
        ]),
        **extra}


def test_port_run_sh_chain_stage_by_stage(tmp_path):
    raw, work = tmp_path / "raw", tmp_path / "work"
    _corpus(raw, str(tmp_path))
    env = _env(work, raw, RUN_UNIT="char")
    outs = {}
    for stage, artifacts in STAGES.items():
        # from a scratch directory: run.sh finds its package itself
        outs[stage] = out = _run(["bash", PORT_RUN, stage], str(tmp_path),
                                 env)
        for a in artifacts:
            assert (work / a).exists(), (
                f"stage {stage} left no {a}; output:\n{out[-2000:]}")
    assert "[train_supervised] attempt 1/24" in outs["train"]
    assert "[train_supervised] done" in outs["train"]
    assert "hostmem: rss" in outs["train"]
    for stage in ("test", "decode", "decode_lm"):
        assert "WER:" in outs[stage], stage
    assert "RNNLM" in outs["decode_lm"]
    # the dumps are line-aligned for the recipe's tools
    n = len((work / "log" / "test_gt.txt").read_text().splitlines())
    assert n == 2 == len((work / "log" / "test_pred.txt").read_text()
                         .splitlines())
    assert not os.path.exists(tmp_path / "summary")
    assert json.load(open(work / "model/las/config.json"))["unit"] == "char"
    # the recommended variant (not in "all"): joint CTC training and joint
    # log-prob beam decoding, into a save_dir of its own
    rec = {**env, "RUN_EXTRA_FLAGS": env["RUN_EXTRA_FLAGS"]
           + f" --save_dir {work}/model/rec/"}
    out = _run(["bash", PORT_RUN, "train_rec"], str(tmp_path), rec)
    assert "[train_supervised] done" in out
    assert json.load(open(work / "model/rec/config.json"))["ctc"] is True
    assert "WER:" in _run(["bash", PORT_RUN, "decode_rec"], str(tmp_path),
                          rec)


def test_train_stage_launches_torchrun_for_several_processes(tmp_path):
    """RUN_NPROC 2 on the CPU: the train stage runs python3 -m
    automatic_speech_recognition_torch.parallel.launch --nproc_per_node 2
    (torchrun --standalone, gloo, with the first failing rank's exit
    code) under the supervisor; the recorded command line shows it, with
    run.sh's train flags and --device."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    rec = bindir / "python3"
    rec.write_text(f"#!{sys.executable}\nimport json, os, sys\n"
                   "open(os.environ['RECORD'], 'a').write("
                   "json.dumps(sys.argv[1:]) + '\\n')\n")
    rec.chmod(0o755)
    log = tmp_path / "calls.jsonl"
    env = {"RECORD": str(log), "PATH": f"{bindir}:{os.environ['PATH']}",
           "RUN_DEVICE": "cpu", "RUN_WORKDIR": str(tmp_path / "w")}
    for nproc, want in (("2", ["-m", "automatic_speech_recognition_torch."
                               "parallel.launch", "--nproc_per_node", "2",
                               "-m",
                               "automatic_speech_recognition_torch.train"]),
                        ("1", ["-m",
                               "automatic_speech_recognition_torch.train"])):
        log.write_text("")
        out = _run(["bash", PORT_RUN, "train"], str(tmp_path),
                   {**env, "RUN_NPROC": nproc})
        argv = json.loads(log.read_text())
        assert argv[:len(want)] == want, argv
        flags = argv[len(want):]
        assert flags[:2] == ["--device", "cpu"]
        for flag, value in (("--enc_units", "512"), ("--epoch", "100"),
                            ("--scan_unroll", "4"),
                            ("--scheduled_sampling", "False")):
            assert flags[flags.index(flag) + 1] == value, flag
        assert "[train_supervised] done" in out


# ----------------------------------------------------------------- slow


def _tree(work):
    """What the comparison reads of a chain's working directory."""
    from automatic_speech_recognition_torch.data import shards
    feats = work / "data" / "LibriSpeech" / "features"
    files = sorted(str(p.relative_to(work)) for p in work.rglob("*")
                   if p.is_file() and "summary" not in p.parts
                   and "model" not in p.parts and "lang" not in p.parts)
    shapes = {p.name: [np.asarray(x).shape for x in
                       np.load(p, allow_pickle=True)]
              for p in sorted(feats.glob("*-feats*.npy"))}
    records = {p.name: shards.get_num_records([str(p)])
               for p in sorted((work / "data" / "shards").glob("*.arsh"))}
    vocab = json.load(open(work / "subword" / "bpe-vocab.json"))
    return files, shapes, records, vocab


@pytest.mark.slow
def test_port_chain_builds_the_jax_chains_artifacts(tmp_path):
    """run.sh (the JAX package) and the port's run.sh on one corpus: the
    same files (checkpoints compared by epoch: orbax directories against
    <epoch>.pt), feature shapes, shard records and vocabulary."""
    raw = tmp_path / "raw"
    _corpus(raw, REPO, port=False)
    works = {}
    for name, cmd in (("jax", ["bash", "run.sh"]),
                      ("port", ["bash", PORT_RUN])):
        works[name] = work = tmp_path / name
        env = _env(work, raw)
        for stage in ("subword", "preprocess", "shards", "train", "test",
                      "lm", "decode"):
            _run(cmd + [stage], REPO, env, timeout=900)
    jax_tree, port_tree = _tree(works["jax"]), _tree(works["port"])
    assert jax_tree == port_tree
    assert (works["jax"] / "model/las/1").is_dir()
    assert (works["port"] / "model/las/1.pt").is_file()
