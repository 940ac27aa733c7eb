"""Data-parallel training on the port (automatic_speech_recognition_torch/
parallel/distributed.py, training/trainer.make_mesh_train_step, the
process-aware checkpoint and train CLI), mirroring tests/test_distributed.py:
two real CPU processes on gloo, each given torchrun's environment by hand.

One pair of processes runs every API check (_WORKER); two more run the
train CLI.  A global batch of 4 rows whose halves hold 13 and 5 tokens,
with BN (apply_bn) and CTC on, goes through a two-rank step, a one-process
step and the JAX package's trainer.train_step on the same parameters
(models/convert.from_jax_params).  Loss and gradient norm agree within
rtol 1e-4, tests/test_torch_train.py's train-step tolerance, and the
parameters by that file's rule, extended to every parameter a training
BN follows (_NOISE_ONLY).

The check is sharp.  Against the right step's loss 8.440676 and gradient
norm 35.388695, a mutated copy of the port that averages the ranks' own
means (DDP's average of per-rank losses and gradients) read 8.450821 and
35.526310 (relative 1.2e-3 and 3.9e-3), and one whose BN normalizes each
rank's rows alone read 8.458462 and 34.188782 (2.1e-3 and 3.4e-2): both
miss rtol 1e-4.  test_naive_data_parallelism_misses_the_tolerance keeps
the two together in the suite.

Randomness: JAX's streams are keys over the global array and cannot be
reproduced per slice (ROADMAP section 3), so the stochastic step is held
to what the split promises instead: the draws for the whole batch (the
shared generator) advance alike on both ranks, the per-row streams
(dropout, sampled tokens, SpecAugment, volume and noise) differ, and both
ranks end with the same parameters.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.parallel import distributed
from automatic_speech_recognition_torch.training import trainer as ttrainer

from test_torch_las import jax_cfg, jax_model, small_cfg
from test_torch_train import _leaves, jax_state, port_state
from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIMEOUT = 300

_WORKER = r"""
import sys
import torch
from automatic_speech_recognition_torch.ops import layers as L
from automatic_speech_recognition_torch.parallel import distributed
from automatic_speech_recognition_torch.parallel.mesh import make_mesh
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

inputs, out_path, ckpt_dir = sys.argv[1:4]
assert distributed.maybe_initialize("cpu") is True
assert distributed.maybe_initialize("cpu") is True      # idempotent
rank, world = distributed.process_index(), distributed.process_count()
assert world == 2 and distributed.is_primary() == (rank == 0)
assert torch.distributed.get_backend() == "gloo"
cpu = torch.device("cpu")
data = torch.load(inputs, weights_only=False)
mesh = make_mesh(devices=[cpu], group=distributed.world_group())
assert mesh.shape == {"data": 2, "model": 1}
out = {"rank": rank}


def rows(batch):
    half = batch[0].shape[0] // 2
    return tuple(x[rank * half:(rank + 1) * half] for x in batch)


def run(name, cfg, batches, perturb=False):
    ts = trainer.create_train_state(cfg, cpu, rank, world)
    ts.model.load_state_dict(data["state"])
    if perturb and rank == 1:       # the broadcast from rank 0 undoes it
        with torch.no_grad():
            for p in ts.model.parameters():
                p.add_(1.0)
    step_fn, ts, shard = trainer.make_mesh_train_step(mesh, ts, None, cfg)
    ms = [step_fn(ts, shard(rows(b))) for b in batches]
    out[name] = {k: [m[k].item() for m in ms]
                 for k in ("loss", "grad_norm", "att_peak")}
    out[name]["state"] = {k: v.clone()
                          for k, v in ts.model.state_dict().items()}
    return ts


cfg = data["cfg"]
run("f32", cfg, data["batches"][:1], perturb=True)
run("bf16", cfg.replace(dtype="bfloat16"), data["batches"][:1])
run("accum", cfg.replace(grad_accum_steps=2), data["batches"][:2])
run("drop_last", cfg.replace(ctc_compat_drop_last=True),
    data["batches"][:1])
rcfg = cfg.replace(dropout_rate=0.3, add_vn=True, scheduled_sampling=True,
                   warmup_step=0, max_step=4, min_rate=0.5,
                   spec_augment=True)
ts = run("random", rcfg, data["batches"][:2])
out["generators"] = {k: getattr(ts, k).get_state().clone()
                     for k in ("generator", "rank_generator",
                               "aug_generator")}

# checkpoints from both ranks: save, overwrite, prune, restore
ckpt = CheckpointManager(ckpt_dir, max_to_keep=2)
for epoch in (1, 1, 2, 3):
    ckpt.save(epoch, ts)
out["epochs"] = ckpt.all_epochs()
back = trainer.create_train_state(rcfg, cpu, rank, world)
assert ckpt.restore(back, epoch=3) is back
out["restored"] = {
    "step": back.step == ts.step,
    "weights": all(torch.equal(a, b) for a, b in zip(
        back.model.state_dict().values(), ts.model.state_dict().values())),
    "generators": all(torch.equal(getattr(back, k).get_state(),
                                  getattr(ts, k).get_state())
                      for k in ("generator", "rank_generator",
                                "aug_generator")),
    "adam": back.optimizer.count == ts.optimizer.count}
ckpt.save_weights(4, ts.model)
out["epochs_after_weights"] = ckpt.all_epochs()
out["mask"] = L.dropout(torch.ones(256), 0.5, True, ts.rank_generator) != 0
out["coin"] = torch.rand((), generator=ts.generator).item()
torch.save(out, out_path)
distributed.barrier("done")
distributed.destroy()
print("WORKEROK", rank)
"""

_CLI = r"""
import json, sys
from automatic_speech_recognition_torch import train
from automatic_speech_recognition_torch.parallel import distributed
ts, hist = train.main(sys.argv[1:])
print("HIST " + json.dumps(dict(hist, step=ts.step)), flush=True)
distributed.destroy()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(code, args_of_rank, world=2):
    """One process per rank with torchrun's variables set by hand."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=port, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + os.environ.get("PYTHONPATH", "").split(
                           os.pathsep)))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args_of_rank(rank)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _finish(procs):
    """Each process's output, once all exit 0 (a failure shows its tail);
    every process is waited for or killed."""
    outs = []
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def _retrying(run):
    """run(attempt); once more, in a fresh directory and on a fresh port,
    if the rendezvous port was taken between _free_port and the bind
    (unlike tests/test_distributed.py's retry, which reuses its
    checkpoint directory)."""
    try:
        return run(0)
    except AssertionError as e:
        if "EADDRINUSE" not in str(e):
            raise
        return run(1)


def _global_batches(rng, n):
    """Global batches of 4 rows: rows 0-1 (rank 0) hold 7 and 6 tokens,
    rows 2-3 (rank 1) 3 and 2, so the halves' token counts differ."""
    out = []
    for _ in range(n):
        x = rng.standard_normal((4, 41, 13, 3)).astype(np.float32)
        xl = np.array([41, 37, 29, 20], np.int32)
        y = rng.integers(3, 29, (4, 7)).astype(np.int32)
        for row, n_tok in enumerate((7, 6, 3, 2)):
            y[row, n_tok - 1] = 2
            y[row, n_tok:] = 0
        out.append((x, xl, y, (y != 0).sum(1).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Run _WORKER on two ranks; returns (cfg, JAX params and BN state,
    global batches, each rank's outputs)."""
    rng = np.random.default_rng(0)
    cfg = small_cfg(apply_bn=True, ctc=True)
    params, state = jax_model(cfg, rng)
    batches = _global_batches(rng, 2)
    model = convert.from_jax_params(params, state, cfg, CPU)

    def run(attempt):
        d = tmp_path_factory.mktemp(f"pair{attempt}")
        torch.save({"cfg": cfg, "state": model.state_dict(),
                    "batches": [tuple(map(torch.from_numpy, b))
                                for b in batches]}, d / "in.pt")
        outs = _finish(_spawn(_WORKER, lambda r: [str(d / "in.pt"),
                                                  str(d / f"out{r}.pt"),
                                                  str(d / "ckpt")]))
        for rank, out in enumerate(outs):
            assert f"WORKEROK {rank}" in out, out[-4000:]
        return [torch.load(d / f"out{r}.pt", weights_only=False)
                for r in range(2)]

    return cfg, params, state, batches, _retrying(run)


def _one_process(cfg, params, state, batches):
    ts = port_state(cfg, params, state)
    ms = [ttrainer.train_step(ts, tuple(map(torch.from_numpy, b)), cfg)
          for b in batches]
    return ts, {k: [m[k].item() for m in ms]
                for k in ("loss", "grad_norm", "att_peak")}


# parameters whose exact gradient is 0 because a training BN follows and
# subtracts the batch mean: both sides compute rounding noise of about
# 1e-9, which Adam divides by its own size, moving them by up to lr
_NOISE_ONLY = ("['conv0']['b']", "['conv1']['b']", "['proj']['b']",
               "['bn_extra']['bias']")


def _assert_trees_close(got, want, steps, lr):
    """Two (params, BN state) trees in the JAX package's layout by
    tests/test_torch_train.py's rule, for a model with apply_bn: the
    parameters in _NOISE_ONLY within 2 steps lr, BN moving means (which
    take 0.01 of that shift a step) within 0.02 steps lr, the rest
    rtol 1e-4 / atol 1e-5."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(_NOISE_ONLY):
            tol = dict(rtol=0, atol=2 * steps * lr)
        elif k.endswith("['mean']"):
            tol = dict(rtol=0, atol=0.02 * steps * lr)
        else:
            tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _tree(cfg, state_dict):
    model = tlas.LAS(cfg)
    model.load_state_dict(state_dict)
    return convert.to_jax_params(model)


def test_maybe_initialize_declines_without_torchrun(monkeypatch):
    for k in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize("cpu") is False
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.world_group() is None
    distributed.barrier("a no-op in one process")


def test_a_rank_without_its_gpu_raises(monkeypatch):
    """LOCAL_RANK names a GPU that is not there: an error before any group
    is joined, never a fallback to the CPU."""
    env = dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="3",
               MASTER_ADDR="localhost", MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.maybe_initialize("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3 has no GPU"):
        distributed.maybe_initialize("cuda")
    assert not distributed.is_initialized()


def test_rank_seeds_differ_by_rank_and_stream():
    seeds = {distributed.rank_seed(7, r, s) for r in range(4)
             for s in range(2)}
    assert len(seeds) == 8 and all(0 <= s < 2 ** 63 for s in seeds)


def test_two_ranks_report_the_same_global_metrics(pair):
    _, _, _, _, got = pair
    for name in ("f32", "bf16", "accum", "drop_last", "random"):
        for k in ("loss", "grad_norm", "att_peak"):
            np.testing.assert_array_equal(got[0][name][k], got[1][name][k],
                                          err_msg=f"{name} {k}")
        for k, v in got[0][name]["state"].items():
            assert torch.equal(v, got[1][name]["state"][k]), (name, k)
        assert np.all(np.isfinite(got[0][name]["loss"]))


def test_two_rank_step_matches_one_process_step(pair):
    """Rank 1 started from other weights: the broadcast from rank 0 makes
    its step rank 0's."""
    cfg, params, state, batches, got = pair
    ts, want = _one_process(cfg, params, state, batches[:1])
    for k in ("loss", "grad_norm", "att_peak"):
        np.testing.assert_allclose(got[0]["f32"][k], want[k], rtol=1e-4,
                                   err_msg=k)
    _assert_trees_close(_tree(cfg, got[0]["f32"]["state"]),
                        convert.to_jax_params(ts.model), 1, cfg.lr)


def test_two_rank_step_matches_jax_train_step(pair):
    cfg, params, state, batches, got = pair
    jts, jm = jtrainer.train_step(jax_state(cfg, params, state), batches[0],
                                  jax_cfg(cfg), dec_steps=7)
    for k in ("loss", "grad_norm", "att_peak"):
        np.testing.assert_allclose(got[0]["f32"][k][0], float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    _assert_trees_close(_tree(cfg, got[0]["f32"]["state"]),
                        (jts.params, jts.bn_state), 1, cfg.lr)


def test_naive_data_parallelism_misses_the_tolerance(pair):
    """Each rank's own mean loss with BN over its own rows, averaged over
    the ranks (DDP's gradient average): the loss and gradient norm the
    step above would read, off by far more than rtol 1e-4."""
    cfg, params, state, batches, got = pair
    losses, grads = [], []
    for half in (slice(0, 2), slice(2, 4)):
        ts = port_state(cfg, params, state)
        rows = tuple(torch.from_numpy(x[half]) for x in batches[0])
        loss, _ = tlas.total_loss(ts.model, rows, cfg, 7, ts.generator, 0)
        losses.append(loss.item())
        grads.append(torch.autograd.grad(loss, ts.optimizer.params))
    naive_loss = float(np.mean(losses))
    naive_norm = ttrainer.global_norm(
        [(a + b) / 2 for a, b in zip(*grads)]).item()
    assert abs(naive_loss / got[0]["f32"]["loss"][0] - 1) > 1e-3
    assert abs(naive_norm / got[0]["f32"]["grad_norm"][0] - 1) > 1e-2


def test_bf16_under_two_ranks(pair):
    """bf16 copies of the float32 masters on both ranks: the float32
    state's step agrees with the one-process bf16 step within rtol 2e-3
    (bf16 rounds a 4-row and a 2-row batch's activations alike, but the
    global BN statistics are summed in another order), and the state
    stays float32."""
    cfg, params, state, batches, got = pair
    c16 = cfg.replace(dtype="bfloat16")
    ts, want = _one_process(c16, params, state, batches[:1])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[0]["bf16"][k], want[k], rtol=2e-3,
                                   err_msg=k)
    assert all(v.dtype == torch.float32
               for v in got[0]["bf16"]["state"].values())


def test_grad_accumulation_under_two_ranks(pair):
    """grad_accum_steps 2: two micro-steps, the ranks' running means
    summed once at the apply, one update, equal to the one-process run.
    The gradient norm is the applied gradient's (the two micro-steps'
    mean), NaN at the first micro-step, before any apply."""
    cfg, params, state, batches, got = pair
    c2 = cfg.replace(grad_accum_steps=2)
    ts, want = _one_process(c2, params, state, batches[:2])
    np.testing.assert_allclose(got[0]["accum"]["loss"], want["loss"],
                               rtol=1e-4)
    norms = got[0]["accum"]["grad_norm"]
    assert np.isnan(norms[0])
    np.testing.assert_allclose(norms[1], ts.optimizer.applied_norm.item(),
                               rtol=1e-4)
    assert abs(norms[1] / want["grad_norm"][1] - 1) > 1e-3
    _assert_trees_close(_tree(c2, got[0]["accum"]["state"]),
                        convert.to_jax_params(ts.model), 1, c2.lr)


def test_ctc_compat_drop_last_drops_the_global_batchs_last_label(pair):
    """The reference's off-by-one drops the batch's last label in
    row-major order: under two ranks it lies on rank 1, and rank 0 keeps
    all of its labels."""
    cfg, params, state, batches, got = pair
    c = cfg.replace(ctc_compat_drop_last=True)
    _, want = _one_process(c, params, state, batches[:1])
    _, keep = _one_process(cfg, params, state, batches[:1])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[0]["drop_last"][k], want[k],
                                   rtol=1e-4, err_msg=k)
    assert abs(want["loss"][0] / keep["loss"][0] - 1) > 1e-3


def test_randomness_shared_per_batch_own_per_row(pair):
    """After two steps with dropout, variational noise, scheduled sampling
    and SpecAugment: the shared stream (the coin, the table noise) is in
    the same state on both ranks and draws the same coin; the per-row
    streams differ and draw different dropout masks."""
    _, _, _, _, got = pair
    g0, g1 = got[0]["generators"], got[1]["generators"]
    assert torch.equal(g0["generator"], g1["generator"])
    assert not torch.equal(g0["rank_generator"], g1["rank_generator"])
    assert not torch.equal(g0["aug_generator"], g1["aug_generator"])
    assert got[0]["coin"] == got[1]["coin"]
    assert not torch.equal(got[0]["mask"], got[1]["mask"])


def test_checkpoints_from_both_ranks(pair):
    """Save, overwrite and prune (max_to_keep 2) from both ranks, the
    primary writing; every rank restores its own per-row streams."""
    _, _, _, _, got = pair
    for out in got:
        assert out["epochs"] == [2, 3]
        assert out["epochs_after_weights"] == [3, 4]
        assert all(out["restored"].values()), out["restored"]


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli"))
    cli_shards(d, np.random.default_rng(0))
    return d


def _cli_argv(d, rank, *extra):
    """The train CLI test's flags; each rank its own --summary_dir, so a
    writer on rank 1 would show."""
    return [a.replace(f"{d}/summary", f"{d}/summary{rank}")
            for a in cli_args(d)] + list(extra)


def _hist(out):
    line = [l for l in out.splitlines() if l.startswith("HIST ")][-1]
    return json.loads(line[5:])


_THREE_STEPS = ("--epoch", "1", "--steps_per_epoch", "3")


@pytest.fixture(scope="module")
def cli_run(cli_dir):
    """Three steps of the CLI on two ranks: (the run's directory, each
    rank's output)."""
    d = cli_dir

    def run(attempt):
        root = f"{d}/run{attempt}"
        return root, _finish(_spawn(_CLI, lambda r: _cli_argv(
            d, r, *_THREE_STEPS, "--save_dir", f"{root}/model",
            "--summary_dir", f"{root}/summary{r}")))

    return _retrying(run)


def test_train_cli_on_two_ranks_matches_one_process(cli_dir, cli_run):
    """Three steps of the CLI on two ranks (each loads its 2 rows of every
    4-row batch) and in one process: the same losses and gradient norms;
    only the primary writes config.json and summaries."""
    d = cli_dir
    root, outs = cli_run
    hists = [_hist(o) for o in outs]
    assert hists[0] == hists[1] and hists[0]["step"] == 3
    assert "mesh: {'data': 2, 'model': 1} over 2 processes, backend gloo" \
        in outs[0]
    cfg = json.load(open(f"{root}/model/config.json"))
    assert cfg["summary_dir"] == f"{root}/summary0"
    assert os.path.exists(f"{root}/summary0/events.jsonl")
    assert not os.path.exists(f"{root}/summary1")
    _, want = train_cli.main(["--device", "cpu"] + cli_args(d) + [
        "--save_dir", f"{d}/model_one", "--summary_dir", f"{d}/s_one",
        *_THREE_STEPS])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(hists[0][k], want[k], rtol=1e-4,
                                   err_msg=k)


def test_two_ranks_resume_into_an_existing_save_dir(cli_dir, cli_run):
    """Both ranks restart in a copy of the directory the three steps
    left (config.json and epoch 1 in it): every rank checks config.json
    before the primary rewrites it (a barrier between), both resume at
    step 3 and take the second epoch's three steps alike, and the
    primary's snapshot names this run's summaries."""
    d, (root, _) = cli_dir, cli_run

    def run(attempt):
        model = f"{root}/resume{attempt}"
        shutil.copytree(f"{root}/model", model)
        return model, _finish(_spawn(_CLI, lambda r: _cli_argv(
            d, r, "--epoch", "2", "--steps_per_epoch", "3",
            "--save_dir", model, "--summary_dir", f"{model}_summary{r}")))

    model, outs = _retrying(run)
    hists = [_hist(o) for o in outs]
    assert hists[0] == hists[1] and hists[0]["step"] == 6
    assert len(hists[0]["loss"]) == 3
    assert "restored epoch 1 (global step 3)" in outs[0]
    cfg = json.load(open(f"{model}/config.json"))
    assert (cfg["epoch"], cfg["summary_dir"]) == (2, f"{model}_summary0")
    assert sorted(os.listdir(model)) == ["1.pt", "2.pt", "config.json"]


def test_sigterm_to_rank_1_stops_both_ranks_with_a_checkpoint(cli_dir):
    """A SIGTERM to rank 1 alone, once the primary has logged the first
    step: both ranks stop at the next logging step where the ranks OR
    their signals (the first step, if rank 1 had not reached its own yet,
    else a multiple of 10), the primary saves, and both exit cleanly.  The waveform perturbations and SpecAugment run
    meanwhile."""
    _sigterm_to_rank_1(cli_dir, "model_term")


def _sigterm_to_rank_1(d, name, *flags):
    """The SIGTERM check above, the model in `d/name`, `flags` added to
    both ranks' command lines."""
    extra = ("--save_dir", f"{d}/{name}", "--epoch", "1",
             "--steps_per_epoch", "1000", "--online_speed_perturb", "True",
             "--online_volume_perturb", "True", "--online_noise_perturb",
             "True", "--spec_augment", "True") + flags
    procs = _spawn(_CLI, lambda r: _cli_argv(d, r, *extra))
    lines, started = [], threading.Event()

    def read_primary():
        for line in procs[0].stdout:
            lines.append(line)
            if "step 1/1000" in line:
                started.set()
        started.set()                   # end of output: failed early

    reader = threading.Thread(target=read_primary, daemon=True)
    reader.start()
    try:
        started.wait(TIMEOUT)
        assert any("step 1/1000" in l for l in lines), \
            "".join(lines)[-4000:]
        procs[1].send_signal(signal.SIGTERM)
        out1 = procs[1].communicate(timeout=TIMEOUT)[0]
        procs[0].wait(timeout=TIMEOUT)
        reader.join(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out0 = "".join(lines)
    assert procs[0].returncode == 0, out0[-4000:]
    assert procs[1].returncode == 0, out1[-4000:]
    assert "signal 15 received" in out1
    steps = {_hist(out0)["step"], _hist(out1)["step"]}
    assert len(steps) == 1
    step = steps.pop()
    assert (step == 1 or step % 10 == 0) and step < 1000   # a logging step
    assert f"preemption checkpoint saved at step {step}" in out0
    assert os.listdir(f"{d}/{name}").count("1.pt") == 1
    # the checkpoint resumes on one process at the step it was cut
    ts, _ = train_cli.main(["--device", "cpu"] + cli_args(d) + [
        "--save_dir", f"{d}/{name}", "--summary_dir", f"{d}/s_{name}",
        "--epoch", "1", "--steps_per_epoch", str(step + 1)])
    assert ts.step == step + 1


def test_batch_sizes_must_divide_by_the_ranks(cli_dir):
    """A global batch of 3 rows cannot split over two ranks: both refuse
    before the first step, as the repository's train.py does."""
    procs = _spawn(_CLI, lambda r: _cli_argv(
        cli_dir, r, "--bucket_batch_sizes", "3,3", "--save_dir",
        f"{cli_dir}/model_odd"))
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "bucket_batch_sizes [3, 3] not divisible by the " \
            "data-parallel mesh axis (2 processes)" in out, out[-3000:]
